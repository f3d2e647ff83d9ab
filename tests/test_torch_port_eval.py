"""The port's evaluation stack against the JAX package's, on the CPU.

  * datasets: the synthetic eval sets (and the hard training set) equal the
    JAX package's frame for frame, byte for byte, in their ground truth and
    visibility; unported registry names raise;
  * metrics: eval/metrics.py equals JAX exactly on seeded random inputs
    (VTUAV subsampling, lasot with visibility, uav NaN annotations, the VOT
    n-1 repair, zero-size boxes) and raises where JAX raises;
  * analysis: extract_results, compute_scores and the printed tables equal
    JAX's exactly on the same result directories;
  * writer: an oracle tracker (it returns the ground truth) through both
    packages' run_sequence writes byte-identical files; skip-if-done
    returns None;
  * trackers end to end: the tiny flagship of tests/test_torch_port_model.py
    in both packages on the same weights over a short synthetic_rgbt,
    through the sequential and the lockstep runners: float trajectories
    within 0.02 px (the bound of tests/test_torch_port_tracker.py), the %d
    files equal except where both floats lie within 0.02 px of an integer,
    and the JAX analysis scores both directories alike wherever their files
    are equal;
  * the CLI, python -m multi_modal_tracking_torch.eval.run, on the CPU with
    create_tracker replaced by the tiny model.
"""
import io
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from multi_modal_tracking_tpu.eval import analysis as jax_analysis
from multi_modal_tracking_tpu.eval import datasets as jax_datasets
from multi_modal_tracking_tpu.eval import metrics as jax_metrics
from multi_modal_tracking_tpu.eval import running as jax_running
from multi_modal_tracking_tpu.tracking import batched as jax_batched
from multi_modal_tracking_tpu.tracking import tracker as jax_tracker
from multi_modal_tracking_tpu.train.data.datasets import synthetic as jax_synthetic

from multi_modal_tracking_torch.eval import analysis, datasets, metrics, run, running
from multi_modal_tracking_torch.eval.data import RGBTSequence, Sequence, SequenceList
from multi_modal_tracking_torch.ops.crop import _crop_window
from multi_modal_tracking_torch.tracking import batched, tracker
from multi_modal_tracking_torch.train.data.datasets import synthetic

from tests.test_torch_port_model import GEOM, S_SZ, T_SZ, _pair
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(template_factor=2.0, template_size=T_SZ, search_factor=4.5, search_size=S_SZ,
          update_interval=3)
# Two short sequences. With random weights the box shrinks to the 10 px
# minimum, and then a 1e-2 px difference between the packages can move the
# crop's integer window by a pixel (round half to even of its corner, or
# the ceil of its side) and the trajectories apart by pixels; on these two
# sequences no window moves (on synthetic_02 one does at frame 7, which
# test_window_flip_explains_the_split_on_synthetic_02 checks).
SHORT = dict(n_sequences=2, n_frames=10)


# ---------------------------------------------------------------- datasets
@pytest.mark.parametrize("name", ["synthetic_rgbt", "synthetic_rgbt_hard"])
def test_synthetic_eval_sets_equal_jax(name):
    want = jax_datasets.get_dataset(name)
    got = datasets.get_dataset(name)
    assert isinstance(got, SequenceList) and len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.name, g.dataset, len(g.frames)) == (w.name, w.dataset, len(w.frames))
        assert isinstance(g, RGBTSequence) and g.ground_truth_rect.dtype == np.float64
        np.testing.assert_array_equal(g.ground_truth_rect, w.ground_truth_rect)
        assert g.init_info() == w.init_info()
        for (gv, gi), (wv, wi) in zip(g.frames, w.frames):
            assert gv.dtype == wv.dtype == np.uint8 and gv.tobytes() == wv.tobytes()
            assert gi.tobytes() == wi.tobytes() and gi.shape == wi.shape
    assert got[want[1].name].name == want[1].name


def test_hard_training_set_equals_jax():
    kw = dict(n_sequences=4, n_frames=30, H=120, W=160, seed_base=3, absent_every=2)
    want, got = jax_synthetic.SyntheticRGBTHard(**kw), synthetic.SyntheticRGBTHard(**kw)
    for k in range(4):
        wi, gi = want.get_sequence_info(k), got.get_sequence_info(k)
        for key in ("bbox", "valid", "visible"):
            np.testing.assert_array_equal(gi[key], wi[key])
        wf, _, _ = want.get_frames(k, [0, 7, 29])
        gf, _, _ = got.get_frames(k, [0, 7, 29])
        assert all(a.tobytes() == b.tobytes() for fw, fg in zip(wf, gf) for a, b in zip(fw, fg))
    assert not got.get_sequence_info(0)["visible"].all()     # absent stretch of seq 0


@pytest.mark.parametrize("name,item", [("lasher", "item 1"), ("vtuav_long", "item 1"),
                                       ("depthtrack", "item 1"), ("lasot", "item 1")])
def test_unported_datasets_raise(name, item, tmp_path, monkeypatch):
    """The file-based sets (ROADMAP.md queue 1 `item`, which they waited
    on) load: with no path configured, an empty set, as the JAX package's
    (tests/test_torch_port_file_datasets.py reads them from trees); an
    unknown name raises."""
    monkeypatch.setenv("MMT_LOCAL_PATHS", str(tmp_path / "none.json"))
    assert name in jax_datasets.dataset_dict and name in datasets.dataset_dict
    got = datasets.get_dataset(name)
    assert isinstance(got, SequenceList) and len(got) == len(jax_datasets.get_dataset(name)) == 0
    with pytest.raises(ValueError, match="Unknown"):
        datasets.get_dataset("no_such_set")


# ----------------------------------------------------------------- metrics
def _boxes(rng, n, lo=0.0):
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(lo, 60, (n, 2))
    return np.concatenate([xy, wh], axis=1)


def _metric_cases():
    rng = np.random.default_rng(5)
    n = 30
    gt = _boxes(rng, n, 5.0)
    gt_vi = np.stack([gt, gt + rng.normal(0, 2, gt.shape)], axis=1)
    pred = gt + rng.normal(0, 6, gt.shape)
    pred[:, 2:] = np.abs(pred[:, 2:])
    zero = pred.copy()
    zero[[3, 4, 9], 2] = 0.0                               # zero-size predictions
    gt_zero = gt.copy()
    gt_zero[[5, 6], 3] = 0.0                               # zero-size annotations
    gt_nan = gt.copy()
    gt_nan[[7, 8]] = np.nan
    vis = rng.random(n) > 0.2
    sparse = np.stack([gt[:3], gt[:3]], axis=1)            # VTUAV: every 10th frame
    nan_pred = pred.copy()
    nan_pred[2, 1] = np.nan
    neg = pred.copy()
    neg[4, 3] = -1.0
    rgbt, uni = "calc_seq_err_robust_rgbt", "calc_seq_err_robust"
    return {
        "rgbt_lasher": (rgbt, pred, gt_vi, "LasHeR", None),
        "rgbt_vtuav": (rgbt, pred, sparse, "VTUAV", None),
        "rgbt_vot_repair": (rgbt, pred[1:], gt_vi, "LasHeR", None),
        "rgbt_short_padded": (rgbt, pred[:20], gt_vi, "RGBT234", None),
        "rgbt_long_trimmed": (rgbt, np.concatenate([pred, pred[:4]]), gt_vi, "GTOT", None),
        "rgbt_lasot_visible": (rgbt, pred, gt_vi, "lasot", vis),
        "rgbt_zero_size": (rgbt, zero, np.stack([gt_zero, gt], axis=1), "LasHeR", None),
        "rgbt_uav_nan": (rgbt, pred, np.stack([gt_nan, gt_nan], axis=1), "uav", None),
        "rgbt_nan_anno": (rgbt, pred, np.stack([gt_nan, gt], axis=1), "LasHeR", None),
        "rgbt_nan_pred": (rgbt, nan_pred, gt_vi, "LasHeR", None),
        "rgbt_negative": (rgbt, neg, gt_vi, "LasHeR", None),
        "uni_otb": (uni, pred, gt, "otb", None),
        "uni_lasot_visible": (uni, pred, gt, "lasot", vis),
        "uni_lasot_short_raises": (uni, pred[:25], gt, "lasot", vis),
        "uni_lasot_long": (uni, np.concatenate([pred, pred[:3]]), gt, "lasot", vis),
        "uni_zero_size": (uni, zero, gt_zero, "otb", None),
        "uni_uav_nan": (uni, pred, gt_nan, "uav", None),
        "uni_nan_anno": (uni, pred, gt_nan, "otb", None),
        "uni_short_padded": (uni, pred[:29], gt, "nfs", None),
    }


def _call(mod, fn, *args):
    try:
        return getattr(mod, fn)(*(np.copy(a) if isinstance(a, np.ndarray) else a
                                  for a in args))
    except ValueError as e:
        return ("raises", str(e))


@pytest.mark.parametrize("case", sorted(_metric_cases()))
def test_metrics_equal_jax(case):
    fn, *args = _metric_cases()[case]
    got, want = _call(metrics, fn, *args), _call(jax_metrics, fn, *args)
    if isinstance(want[0], str):
        assert got == want
        return
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_metric_helpers_equal_jax():
    rng = np.random.default_rng(6)
    a, b = _boxes(rng, 50, 0.0), _boxes(rng, 50, 1.0)
    np.testing.assert_array_equal(metrics.calc_iou_overlap(a, b),
                                  jax_metrics.calc_iou_overlap(a, b))
    for norm in (False, True):
        np.testing.assert_array_equal(metrics.calc_err_center(a, b, norm),
                                      jax_metrics.calc_err_center(a, b, norm))


# ---------------------------------------------------------------- analysis
def _write_results(root, seqs, seed, drop=None):
    """Noisy boxes around the ground truth as %d result files."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for s in seqs:
        if s.name == drop:
            continue
        gt = s.ground_truth_rect[:, 0]
        pred = gt + rng.normal(0, 4, gt.shape)
        pred[:, 2:] = np.abs(pred[:, 2:]) + 1
        np.savetxt(os.path.join(root, f"{s.name}.txt"), pred, delimiter="\t", fmt="%d")


@pytest.mark.parametrize("opts", [{}, {"exclude_invalid_frames": True},
                                  {"skip_missing_seq": True}], ids=["plain", "exclude", "skip"])
def test_analysis_equals_jax(tmp_path, opts):
    seqs = datasets.get_dataset("synthetic_rgbt_hard", n_sequences=4, n_frames=20)
    jseqs = jax_datasets.get_dataset("synthetic_rgbt_hard", n_sequences=4, n_frames=20)
    drop = "synthetic_hard_02" if opts.get("skip_missing_seq") else None
    _write_results(str(tmp_path / "a"), seqs, 1, drop)
    _write_results(str(tmp_path / "b"), seqs, 2)
    dirs = [(str(tmp_path / "a"), "trk_a"), (str(tmp_path / "b"), None)]
    got = analysis.extract_results([analysis.TrackerResults(d, n) for d, n in dirs], seqs,
                                   **opts)
    want = jax_analysis.extract_results([jax_analysis.TrackerResults(d, n) for d, n in dirs],
                                        jseqs, **opts)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]
    sg, sw = analysis.compute_scores(got), jax_analysis.compute_scores(want)
    for k in sw:
        np.testing.assert_array_equal(np.asarray(sg[k]), np.asarray(sw[k]))
    assert analysis.generate_formatted_report(sg["trackers"], sg, "rep") == \
        jax_analysis.generate_formatted_report(sw["trackers"], sw, "rep")
    outs = []
    for mod, data in ((analysis, got), (jax_analysis, want)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.print_results([], None, report_name="r", eval_data=data)
            mod.print_per_sequence_results([], None, eval_data=data)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "AUC" in outs[0]


# ------------------------------------------------------------------ writer
class _Oracle:
    """Returns the ground truth (non-integer floats) frame by frame."""

    def __init__(self, gt):
        self.gt, self.k = gt, 0

    def initialize(self, image, info):
        self.k = 0

    def track(self, image, info=None):
        self.k += 1
        return {"target_bbox": list(self.gt[self.k])}


def test_writer_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    n = 12
    frames = [(rng.integers(0, 255, (24, 32, 3), np.uint8),
               rng.integers(0, 255, (24, 32, 3), np.uint8)) for _ in range(n)]
    gt = _boxes(rng, n, 1.0) - 3.7
    seq_p = RGBTSequence("oracle", frames, "LasHeR", np.stack([gt, gt + 1], axis=1))
    from multi_modal_tracking_tpu.eval.data import RGBTSequence as JaxRGBTSequence
    seq_j = JaxRGBTSequence("oracle", frames, "LasHeR", np.stack([gt, gt + 1], axis=1))
    sp = running.run_sequence(seq_p, _Oracle(gt), str(tmp_path / "p"), report_fps=False)
    sj = jax_running.run_sequence(seq_j, _Oracle(gt), str(tmp_path / "j"), report_fps=False)
    with open(tmp_path / "p" / "oracle.txt", "rb") as f1, \
            open(tmp_path / "j" / "oracle.txt", "rb") as f2:
        assert f1.read() == f2.read()
    np.testing.assert_array_equal(sp["boxes"], gt)
    assert (sp["seq"], sp["n_frames"]) == (sj["seq"], sj["n_frames"])
    assert np.loadtxt(tmp_path / "p" / "oracle_time.txt").shape == (n,)
    assert running.run_sequence(seq_p, _Oracle(gt), str(tmp_path / "p")) is None
    assert not os.path.exists(tmp_path / "p" / "oracle_score.txt")


class _Still:
    """Keeps the init box; one instance per worker thread."""

    def initialize(self, image, info):
        self.box = info["init_bbox"][0]

    def track(self, image, info=None):
        return {"target_bbox": self.box}


def test_run_dataset_threads_one_tracker_per_worker(tmp_path):
    made = []

    def factory():
        made.append(_Still())
        return made[-1]
    seqs = datasets.get_dataset("synthetic_rgbt", n_sequences=3, n_frames=5)
    stats = running.run_dataset(seqs, None, str(tmp_path), threads=2, tracker_factory=factory)
    assert sorted(s["seq"] for s in stats) == [s.name for s in seqs]
    assert 1 <= len(made) <= 2
    for s in seqs:
        np.testing.assert_array_equal(np.loadtxt(tmp_path / f"{s.name}.txt"),
                                      np.trunc(np.tile(s.ground_truth_rect[0, 0], (5, 1))))


def test_runner_options_that_raise(tmp_path, monkeypatch):
    """Path frames are decoded; one that cannot be read raises with its path
    (tests/test_torch_port_file_datasets.py tracks from files). save_vis
    without cv2 (the video container's writer) raises ImportError naming it,
    before tracking (test_run_sequence_save_vis_writes_the_video writes
    one)."""
    seq = RGBTSequence("paths", [("a.jpg", "b.jpg")] * 3, "LasHeR", np.ones((3, 2, 4)))
    with pytest.raises(ValueError, match="a.jpg: cannot read the file"):
        running.run_sequence(seq, _Oracle(np.ones((3, 4))), str(tmp_path))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        with pytest.raises(ImportError, match="cv2"):
            running.run_sequence(seq, _Oracle(np.ones((3, 4))), str(tmp_path), save_vis=True)
    with pytest.raises(ValueError, match="threads > 0 and a tracker_factory"):
        running.run_dataset([seq], None, str(tmp_path), devices=["cuda:0", "cuda:1"])
    # the prefetcher hands a loading error to the consumer
    with pytest.raises(ValueError, match="a.jpg"):
        list(running._Prefetcher(seq, 1, 2))
    uni = Sequence("uni", [np.zeros((4, 4, 3), np.uint8)] * 2, "otb", np.ones((2, 4)))
    assert running._load_frame(uni, 1).shape == (4, 4, 3)


def test_run_sequence_save_vis_writes_the_video(tmp_path, monkeypatch):
    """save_vis tracks frame by frame and writes vis_video/<seq>.mp4 of the
    JAX runner's frames (jax_running._vis_frame: the predicted box and the
    search region around the previous one), through cv2."""
    import cv2
    seq = datasets.get_dataset("synthetic_rgbt", n_sequences=1, n_frames=6)[0]
    gt = seq.ground_truth_rect[:, 0] + np.array([0.3, -0.6, 4.7, 2.2])
    got = []
    write = running.write_video
    monkeypatch.setattr(running, "write_video",
                        lambda path, frames, **kw: got.append(list(frames)) or
                        write(path, got[-1], **kw))
    running.run_sequence(seq, _Oracle(gt), str(tmp_path), save_vis=True, report_fps=False)
    path = tmp_path / "vis_video" / f"{seq.name}.mp4"
    cap = cv2.VideoCapture(str(path))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    boxes = gt.copy()                         # the float boxes the runner holds
    boxes[0] = running._select_init_box(seq.init_info()["init_bbox"])
    for k, frame in enumerate(got[0], start=1):
        want = jax_running._vis_frame(seq.frames[k][0].copy(), boxes[k], boxes[k - 1], 4.5)
        np.testing.assert_array_equal(frame, want)


def test_cli_vis_search_writes_videos(tiny_cli, tmp_path):
    out = run.main(BASE + ["--sequence", "synthetic_01", "--vis_search"])
    assert os.listdir(os.path.join(out[0], "vis_video")) == ["synthetic_01.mp4"]


# ------------------------------------------------------ trackers end to end
@pytest.fixture(scope="module")
def pair():
    return _pair(GEOM, 51)


def _near_int(x, tol=0.02):
    return np.abs(x - np.round(x)) <= tol


def _compare_dirs(pdir, jdir, seqs, port_floats, jax_floats):
    """Floats within 0.02 px; %d files equal except where both floats lie
    within 0.02 px of an integer. Returns the names whose files are equal."""
    equal = []
    for s in seqs:
        pf, jf = port_floats[s.name], jax_floats[s.name]
        np.testing.assert_allclose(pf, jf, rtol=0, atol=0.02)
        pt = np.loadtxt(os.path.join(pdir, f"{s.name}.txt"))
        jt = np.loadtxt(os.path.join(jdir, f"{s.name}.txt"))
        diff = pt != jt
        assert (_near_int(pf[diff]) & _near_int(jf[diff])).all(), s.name
        if not diff.any():
            equal.append(s.name)
    return equal


def _assert_scores_where_equal(pdir, jdir, jseqs, equal):
    data = jax_analysis.extract_results([jax_analysis.TrackerResults(pdir),
                                         jax_analysis.TrackerResults(jdir)], jseqs)
    for i, name in enumerate(data["sequences"]):
        if name in equal:
            for key in ("ave_success_rate_plot_overlap", "ave_success_rate_plot_center",
                        "ave_success_rate_plot_center_norm"):
                np.testing.assert_array_equal(data[key][i, 0], data[key][i, 1])
    if len(equal) == len(jseqs):
        sc = jax_analysis.compute_scores(data)
        for k in ("AUC", "OP50", "OP75", "Precision", "Norm Precision"):
            assert sc[k][0] == sc[k][1]


def _jax_float_trajectories(jmodel, variables, jseqs):
    out = {}
    for s in jseqs:
        jt = jax_tracker.RGBTCachedTrackerJit(model=jmodel, variables=variables, scan_chunk=4,
                                              **KW)
        jt.initialize(list(s.frames[0]), s.init_info())
        fv = np.stack([f[0] for f in s.frames[1:]])
        fi = np.stack([f[1] for f in s.frames[1:]])
        out[s.name] = np.concatenate([np.asarray(s.ground_truth_rect[:1, 0]),
                                      np.asarray(jt.track_chunk(fv, fi), np.float64)])
    return out


def test_sequential_runner_matches_jax(pair, tmp_path):
    jmodel, variables, pmodel = pair
    seqs = datasets.get_dataset("synthetic_rgbt", **SHORT)
    jseqs = jax_datasets.get_dataset("synthetic_rgbt", **SHORT)
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    pt = tracker.RGBTCachedTracker(pmodel, device="cpu", **KW)
    stats = running.run_dataset(seqs, pt, pdir, chunk=4)
    jt = jax_tracker.RGBTCachedTrackerJit(model=jmodel, variables=variables, scan_chunk=4, **KW)
    jax_running.run_dataset(jseqs, jt, jdir, chunk=4)
    port_floats = {s["seq"]: s["boxes"] for s in stats}
    equal = _compare_dirs(pdir, jdir, seqs, port_floats,
                          _jax_float_trajectories(jmodel, variables, jseqs))
    _assert_scores_where_equal(pdir, jdir, jseqs, equal)


def _windows(box, factor):
    """The crop window of ops/crop.py at an f32 box: (x1, y1, side) and the
    values before rounding (corner before half-to-even, side before ceil)."""
    import torch
    b = torch.as_tensor(np.asarray(box, np.float32))
    x1, y1, side, side_f = _crop_window(b, factor)
    x, y, w, h = b.unbind(-1)
    pre_side = torch.sqrt(w * h) * factor
    pre = (x + 0.5 * w - side_f * 0.5, y + 0.5 * h - side_f * 0.5, pre_side)
    return (int(x1), int(y1), int(side)), tuple(float(v) for v in pre)


def test_window_flip_explains_the_split_on_synthetic_02(pair):
    """On synthetic_02 the packages split by pixels from one frame on. Up to
    the first frame whose integer crop window differs between them, the
    trajectories agree within 0.02 px; at that window the component that
    differs lies, in both packages, within 0.02 px of the box of its rounding
    boundary (a corner within 0.02 px of a half-integer, the side's
    sqrt(w*h) within 0.02 px of where ceil(sqrt(w*h)*factor) steps)."""
    jmodel, variables, pmodel = pair
    kw = dict(n_sequences=3, n_frames=10)
    seq = datasets.get_dataset("synthetic_rgbt", **kw)[2]
    jseq = jax_datasets.get_dataset("synthetic_rgbt", **kw)[2]
    assert seq.name == "synthetic_02"
    jf = _jax_float_trajectories(jmodel, variables, [jseq])[jseq.name]
    pt = tracker.RGBTCachedTracker(pmodel, device="cpu", **KW)
    pt.initialize(list(seq.frames[0]), seq.init_info())
    pf = np.concatenate([seq.ground_truth_rect[:1, 0].astype(np.float64), pt.track_chunk(
        np.stack([f[0] for f in seq.frames[1:]]), np.stack([f[1] for f in seq.frames[1:]]))])
    # the crops frame k depends on: the search window at the box of k - 1,
    # and the template re-cropped at the box of every update frame before k
    first = None
    for k in range(1, len(pf)):
        crops = [(k - 1, KW["search_factor"])] + [
            (u, KW["template_factor"]) for u in range(KW["update_interval"], k,
                                                      KW["update_interval"])]
        for at, factor in crops:
            (wp, pre_p), (wj, pre_j) = _windows(pf[at], factor), _windows(jf[at], factor)
            if wp != wj:
                first = (k, at, factor, wp, wj, pre_p, pre_j)
                break
        if first:
            break
    assert first is not None, "no window moves on synthetic_02: the split has another cause"
    k, at, factor, wp, wj, pre_p, pre_j = first
    np.testing.assert_allclose(pf[:k], jf[:k], rtol=0, atol=0.02)
    if wp[2] != wj[2]:           # the side: ceil of sqrt(w*h)*factor
        for pre in (pre_p, pre_j):
            assert abs(pre[2] - round(pre[2])) <= 0.02 * factor, (pre, factor)
    else:                        # a corner: half to even
        comp = [c for c in (0, 1) if wp[c] != wj[c]]
        for pre in (pre_p, pre_j):
            for c in comp:
                assert abs(abs(pre[c] - np.floor(pre[c])) - 0.5) <= 0.02, (pre, c)
    assert np.abs(pf[k:] - jf[k:]).max() > 0.02   # and the split follows


def test_batched_runner_matches_jax(pair, tmp_path):
    """Both packages' lockstep runners over ragged sequences (one is cut
    short); JAX's batched floats equal its sequential ones within 1e-3 px
    (tests/test_batched_tracking.py), so they are the reference here."""
    jmodel, variables, pmodel = pair
    seqs = datasets.get_dataset("synthetic_rgbt", **SHORT)
    jseqs = jax_datasets.get_dataset("synthetic_rgbt", **SHORT)
    for s in (seqs[1], jseqs[1]):
        s.frames = s.frames[:7]
        s.ground_truth_rect = s.ground_truth_rect[:7]
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    bt = batched.BatchedRGBTCachedTracker(pmodel, device="cpu", **KW)
    stats = batched.run_sequences_batched(list(seqs), bt, pdir, chunk=4)
    jbt = jax_batched.BatchedRGBTCachedTrackerJit(model=jmodel, variables=variables,
                                                  scan_chunk=4, **KW)
    jax_batched.run_sequences_batched(list(jseqs), jbt, jdir, chunk=4)
    port_floats = {s["seq"]: s["boxes"] for s in stats}
    equal = _compare_dirs(pdir, jdir, seqs, port_floats,
                          _jax_float_trajectories(jmodel, variables, jseqs))
    _assert_scores_where_equal(pdir, jdir, jseqs, equal)


# --------------------------------------------------------------------- CLI
@pytest.fixture
def tiny_cli(pair, monkeypatch, tmp_path):
    """eval.run with create_tracker building the tiny model on the CPU, the
    datasets cut to 8 frames a sequence; local paths (results_path) under
    tmp_path."""
    from multi_modal_tracking_torch.train.admin import create_default_local_file
    local = tmp_path / "local_paths.json"
    monkeypatch.setenv("MMT_LOCAL_PATHS", str(local))
    create_default_local_file(save_dir=str(tmp_path / "out"), path=str(local))
    made = []

    def tiny(params, dataset_name="", device="cuda", **kw):
        made.append((params, dataset_name, device))
        return tracker.RGBTCachedTracker(pair[2], template_factor=params.template_factor,
                                         template_size=T_SZ, search_factor=params.search_factor,
                                         search_size=S_SZ, update_interval=3, device=device)
    monkeypatch.setattr(run, "create_tracker", tiny)
    monkeypatch.setattr(run, "get_dataset", lambda name: datasets.get_dataset(name, n_frames=8))
    return made


BASE = ["asymmetric_shared_ce", "attention_lasher_newfusion_2layer", "--device", "cpu",
        "--chunk", "8", "--dtype", "float32"]


def test_cli_layout_sequence_rerun_and_overrides(tiny_cli, tmp_path, capsys):
    made = tiny_cli
    out = run.main(BASE + ["--sequence", "synthetic_01", "--params__search_factor", "4.0"])
    want = os.path.join(str(tmp_path / "out"), "test/tracking_results", "asymmetric_shared_ce",
                        "attention_lasher_newfusion_2layer", "synthetic_rgbt")
    assert out == [want]
    assert sorted(os.listdir(want)) == ["synthetic_01.txt", "synthetic_01_time.txt"]
    params, ds_name, device = made[-1]
    assert params.search_factor == 4.0 and ds_name == "synthetic_rgbt" and device == "cpu"
    assert params.cfg.TEST.SEARCH_SIZE == 288           # the tracking.yaml overlay
    assert "Report: synthetic_rgbt, 1 / 1 sequences" in capsys.readouterr().out
    path = os.path.join(want, "synthetic_01.txt")
    with open(path, "w") as f:
        f.write("1\t2\t3\t4\n")
    run.main(BASE + ["--sequence", "synthetic_01"])                  # skipped: kept
    assert open(path).read() == "1\t2\t3\t4\n"
    run.main(BASE + ["--sequence", "synthetic_01", "--rerun"])       # rewritten
    assert np.loadtxt(path).shape == (8, 4)


def test_cli_batch_sequences_and_checkpoint_sweep(tiny_cli, tmp_path, capsys):
    res = str(tmp_path / "res")
    out = run.main(BASE + ["--results_dir", res, "--batch_sequences", "3"])
    assert out == [os.path.join(res, "synthetic_rgbt")]
    seq_out = run.main(BASE + ["--results_dir", str(tmp_path / "seq")])
    for k in range(3):
        b = np.loadtxt(os.path.join(out[0], f"synthetic_{k:02d}.txt"))
        s = np.loadtxt(os.path.join(seq_out[0], f"synthetic_{k:02d}.txt"))
        assert b.shape == (8, 4) and np.abs(b - s).max() <= 1
    assert "3 / 3 sequences" in capsys.readouterr().out
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    for ep in (5, 12, 15):
        (ckdir / f"MixFormerRGBT_ep{ep:04d}.pth.tar").write_bytes(b"")
    out = run.main(BASE + ["--results_dir", res, "--checkpoint_dir", str(ckdir),
                           "--sequence", "synthetic_00"])
    assert out == [os.path.join(res + "_ep12", "synthetic_rgbt"),
                   os.path.join(res + "_ep15", "synthetic_rgbt")]
    assert [p.checkpoint for p, _, _ in tiny_cli[-2:]] == \
        [str(ckdir / "MixFormerRGBT_ep0012.pth.tar"), str(ckdir / "MixFormerRGBT_ep0015.pth.tar")]


@pytest.mark.parametrize("extra,exc,match", [
    # the videos need cv2's container writer: without cv2 it raises
    # (test_cli_vis_search_writes_videos writes them)
    (["--vis_search"], ImportError, "cv2"),
    # the file-based sets are read (tests/test_torch_port_file_datasets.py
    # runs eval.run on a LasHeR tree); a name the registry lacks raises
    (["--dataset_name", "lasher_2024"], ValueError, "Unknown dataset 'lasher_2024'"),
], ids=["vis_search", "file_dataset"])
def test_cli_unported_options_raise(tiny_cli, extra, exc, match, monkeypatch):
    if "--vis_search" in extra:
        monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(exc, match=match):
        run.main(BASE + extra)
