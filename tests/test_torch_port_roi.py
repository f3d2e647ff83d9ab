"""ROI-window uploads in the port, on the CPU: the cases of
tests/test_roi_window.py (:41, :55, :71, :83, :159, :183, :205) on the
port's own functions, with the JAX package's `crop_resize_window` as the
reference of the validity flag.

  * crop_resize_window is bit-identical to crop_resize wherever it says ok,
    and its ok flags equal the JAX package's on the same inputs;
  * track_chunk_roi with a window covering the crops equals track_chunk
    bit for bit (a template-cache rebuild inside the chunk included); a
    window the crops leave is flagged, and restore + a full-frame redo
    gives the full-frame trajectory exactly;
  * run_sequence(roi_margin=...) writes the full-frame path's files byte
    for byte, with a generous margin and with a tight one that falls back;
  * snapshot is not written into by later steps.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.ops import crop as jax_crop

from multi_modal_tracking_torch.ops.crop import crop_resize, crop_resize_window
from multi_modal_tracking_torch.tracking.tracker import RGBTCachedTracker

from tests.test_torch_port_model import GEOM, S_SZ, T_SZ, _pair
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 120, 160
OUT = 48


def _frame(seed=0):
    return np.random.default_rng(seed).integers(0, 255, (H, W, 3), dtype=np.uint8)


def _both(frame, box, off, wsz, factor):
    """(port crop_resize, port window crop, port ok, JAX ok)."""
    ox, oy = off
    ww, hw = wsz
    win = frame[oy:oy + hw, ox:ox + ww]
    want, rf_want = crop_resize(torch.from_numpy(frame), torch.tensor(box), factor, OUT)
    got, rf_got, ok = crop_resize_window(torch.from_numpy(np.ascontiguousarray(win)),
                                         torch.tensor(box), (ox, oy), (H, W), factor, OUT)
    _, _, jok = jax_crop.crop_resize_window(jnp.asarray(win), jnp.asarray(box, jnp.float32),
                                            jnp.asarray([ox, oy], jnp.int32), (H, W), factor,
                                            OUT)
    assert float(rf_want) == float(rf_got)
    return want, got, bool(ok), bool(jok)


@pytest.mark.parametrize("box,off,wsz", [
    ([60.0, 50.0, 20.0, 16.0], (30, 20), (100, 80)),   # interior crop
    ([10.0, 8.0, 18.0, 14.0], (0, 0), (80, 70)),       # frame corner
    ([140.0, 100.0, 24.0, 18.0], (80, 50), (80, 70)),  # pads off-frame; the window
])                                                     # touches the last row/column
def test_window_crop_bit_identical_when_valid(box, off, wsz):
    want, got, ok, jok = _both(_frame(), box, off, wsz, 4.0)
    assert ok and jok
    assert torch.equal(want, got)


def test_window_crop_flags_missing_pixels():
    frame = _frame(1)
    box = [60.0, 50.0, 30.0, 30.0]          # crop side ceil(30 * 4) = 120
    _, _, ok, jok = _both(frame, box, (43, 34), (64, 64), 4.0)
    assert not ok and not jok
    _, _, ok2, jok2 = _both(frame, box, (43, 34), (64, 64), 2.0)   # template-size crop fits
    assert ok2 and jok2


def test_window_empty_crop_region_valid():
    """A crop entirely off the frame reads nothing: zeros either way."""
    want, got, ok, jok = _both(_frame(2), [-300.0, -300.0, 20.0, 20.0], (0, 0), (64, 64), 4.0)
    assert ok and jok
    assert torch.equal(want, got) and not want.any()


def test_window_sweep_flags_equal_jax_and_exact_when_valid():
    rng = np.random.default_rng(7)
    frame = _frame(3)
    n_ok = n_bad = 0
    for _ in range(40):
        box = [float(rng.uniform(-20, W)), float(rng.uniform(-20, H)),
               float(rng.uniform(5, 40)), float(rng.uniform(5, 40))]
        ww, hw = int(rng.integers(32, W)), int(rng.integers(32, H))
        ox, oy = int(rng.integers(0, W - ww + 1)), int(rng.integers(0, H - hw + 1))
        want, got, ok, jok = _both(frame, box, (ox, oy), (ww, hw), 3.5)
        assert ok == jok
        if ok:
            assert torch.equal(want, got), "a valid window gave other pixels"
            n_ok += 1
        else:
            n_bad += 1
    assert n_ok and n_bad, "the sweep must hit both valid and invalid windows"


# ---------------------------------------------------------------- tracker
@pytest.fixture(scope="module")
def tracker():
    _, _, pmodel = _pair(GEOM, 41)
    return RGBTCachedTracker(pmodel, template_factor=2.0, template_size=T_SZ, search_factor=4.5,
                             search_size=S_SZ, update_interval=3, device="cpu")


def _rgbt_frames(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (n, H, W, 3), dtype=np.uint8),
            rng.integers(0, 255, (n, H, W), dtype=np.uint8))


INIT = {"init_bbox": [70.0, 50.0, 16.0, 14.0]}


def _coverage_window(boxes, factor, pad=4):
    """Smallest window covering every frame's crop read region (+pad)."""
    los, his = [], []
    for b in boxes:
        side = math.ceil(math.sqrt(b[2] * b[3]) * factor)
        x1 = round(b[0] + 0.5 * b[2] - side * 0.5)
        y1 = round(b[1] + 0.5 * b[3] - side * 0.5)
        los.append((max(x1, 0), max(y1, 0)))
        his.append((min(x1 + side, W - 1), min(y1 + side, H - 1)))
    ox = max(min(lo[0] for lo in los) - pad, 0)
    oy = max(min(lo[1] for lo in los) - pad, 0)
    hx = min(max(h[0] for h in his) + pad, W)
    hy = min(max(h[1] for h in his) + pad, H)
    return (ox, oy), (hy - oy, hx - ox)


def test_track_chunk_roi_bit_exact(tracker):
    """A window covering every crop of the chunk: ROI == full frames bit for
    bit, across the cache rebuild at frame 3 and 6."""
    fv, fi = _rgbt_frames(7, 11)
    tracker.initialize([fv[0], fi[0]], INIT)
    want = tracker.track_chunk(fv[1:], fi[1:])
    states = np.concatenate([[INIT["init_bbox"]], want], axis=0)
    (ox, oy), (hw, ww) = _coverage_window(states, tracker.search_factor)
    assert (hw, ww) != (H, W), "the window degenerated to the frame"
    tracker.initialize([fv[0], fi[0]], INIT)
    got, oks = tracker.track_chunk_roi(np.ascontiguousarray(fv[1:, oy:oy + hw, ox:ox + ww]),
                                       np.ascontiguousarray(fi[1:, oy:oy + hw, ox:ox + ww]),
                                       (ox, oy))
    assert oks.dtype == bool and oks.all(), oks
    np.testing.assert_array_equal(got, want)


def test_track_chunk_roi_flags_escape_and_falls_back(tracker):
    fv, fi = _rgbt_frames(7, 12)
    tracker.initialize([fv[0], fi[0]], INIT)
    want = tracker.track_chunk(fv[1:], fi[1:])
    tracker.initialize([fv[0], fi[0]], INIT)
    snap = tracker.snapshot()
    kept = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in snap.items()
            if k != "_cache"}
    kv0 = snap["_cache"]["kv"][0]["kV"].clone()
    ox, oy, ww, hw = 64, 40, 48, 48          # far smaller than the crops read
    _, oks = tracker.track_chunk_roi(np.ascontiguousarray(fv[1:, oy:oy + hw, ox:ox + ww]),
                                     np.ascontiguousarray(fi[1:, oy:oy + hw, ox:ox + ww]),
                                     (ox, oy))
    assert not oks.all()
    # the steps rebound the state; the snapshot's tensors are as taken
    for k, v in kept.items():
        assert torch.equal(snap[k], v) if isinstance(v, torch.Tensor) else snap[k] == v
    assert torch.equal(snap["_cache"]["kv"][0]["kV"], kv0)
    tracker.restore(snap)
    np.testing.assert_array_equal(tracker.track_chunk(fv[1:], fi[1:]), want)


def test_run_sequence_roi_mode_exact_results(tracker, tmp_path):
    """Result files of ROI mode == the full-frame path's, byte for byte, with
    chunks that stay in their window and ones that leave it and fall
    back."""
    from multi_modal_tracking_torch.eval.data import RGBTSequence
    from multi_modal_tracking_torch.eval.running import run_sequence
    fv, fi = _rgbt_frames(10, 13)
    frames = [(fv[k], np.repeat(fi[k][..., None], 3, axis=-1)) for k in range(10)]
    seq = RGBTSequence("roiseq", frames, "LasHeR", np.tile(np.asarray(INIT["init_bbox"]),
                                                           (10, 2, 1)))
    plain = run_sequence(seq, tracker, str(tmp_path / "plain"), chunk=4, report_fps=False)
    with open(tmp_path / "plain" / "roiseq.txt", "rb") as f:
        want = f.read()
    windowed = fallbacks = 0
    # a generous margin, a tight one, and one smaller than the search region
    for tag, margin, min_size, align in (("roi", 2.0, 64, 16), ("roi_tight", 1.05, 64, 16),
                                         ("roi_escape", 0.5, 16, 8)):
        st = run_sequence(seq, tracker, str(tmp_path / tag), chunk=4, report_fps=False,
                          roi_margin=margin, roi_min_size=min_size, roi_align=align)
        with open(tmp_path / tag / "roiseq.txt", "rb") as f:
            assert f.read() == want, tag
        np.testing.assert_array_equal(st["boxes"], plain["boxes"])
        assert st["n_chunks"] == 3
        windowed += st["n_windowed"]
        fallbacks += st["n_fallback"]
    assert windowed > 0 and fallbacks > 0
