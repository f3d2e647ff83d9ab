"""The port's lockstep trackers (multi_modal_tracking_torch.tracking.batched)
on the CPU, at the tiny flagship geometry of tests/test_torch_port_model.py
(CE at blocks 1/3, LNSpecific fusion, CORNER_UP head):

  * BatchedRGBTTracker / BatchedRGBTCachedTracker equal the port's
    sequential trackers within 1e-3 px over ragged lengths and
    template-update crossings (update interval 3), the cases of
    tests/test_batched_tracking.py:36 and :74 (which hold the JAX lockstep
    trackers to their sequential ones at the same bound). The N sequences
    run as one (2N, ...) batch through the model; batched products may sum
    in another order than single ones, which is all 1e-3 px allows;
  * the port's lockstep tracker agrees with the JAX package's within
    0.02 px (the cross-package bound of tests/test_torch_port_tracker.py);
  * a valid mask that is not suffix-style raises;
  * run_sequences_batched writes the runner's files, and they agree with
    the sequential runner's.
"""
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.tracking import batched as jax_batched

from multi_modal_tracking_torch.tracking import batched as port_batched
from multi_modal_tracking_torch.tracking import tracker as port_tracker

from tests.test_torch_port_model import GEOM, S_SZ, T_SZ, _pair
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 96, 128
KW = dict(template_factor=2.0, template_size=T_SZ, search_factor=4.5, search_size=S_SZ,
          update_interval=3)
BOXES0 = np.asarray([[40.0, 30, 30, 24], [50.0, 20, 24, 30], [30.0, 40, 20, 20]], np.float32)


@pytest.fixture(scope="module")
def pair():
    return _pair(GEOM, 31)


def _seq_frames(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (n, H, W, 3), np.uint8),
            rng.integers(0, 255, (n, H, W, 3), np.uint8))


def _block(seqs, lengths):
    """(T, N, H, W, 3) stacks padded with each sequence's last frame, and
    the suffix-style valid mask."""
    T, N = max(lengths) - 1, len(seqs)
    fv = np.zeros((T, N, H, W, 3), np.uint8)
    fi = np.zeros_like(fv)
    ok = np.zeros((T, N), np.bool_)
    for j in range(N):
        for t in range(T):
            k = min(t + 1, lengths[j] - 1)
            fv[t, j], fi[t, j] = seqs[j][0][k], seqs[j][1][k]
            ok[t, j] = t + 1 < lengths[j]
    return fv, fi, ok


@pytest.mark.parametrize("cached,lengths,seed", [
    (False, [7, 5, 7], 0),
    (True, [9, 5, 9], 10),          # crosses the updates at frames 3 and 6
], ids=["full", "cached"])
def test_batched_matches_sequential(pair, cached, lengths, seed):
    _, _, pmodel = pair
    single_cls = port_tracker.RGBTCachedTracker if cached else port_tracker.RGBTTracker
    batched_cls = (port_batched.BatchedRGBTCachedTracker if cached
                   else port_batched.BatchedRGBTTracker)
    seqs = [_seq_frames(lengths[j], seed + j) for j in range(3)]
    want = []
    for j in range(3):
        tr = single_cls(pmodel, device="cpu", **KW)
        tr.initialize([seqs[j][0][0], seqs[j][1][0]], {"init_bbox": BOXES0[j]})
        want.append(tr.track_chunk(seqs[j][0][1:], seqs[j][1][1:]))

    calls = []
    fwd = pmodel.forward_track if cached else pmodel.forward
    orig = type(pmodel).forward_track if cached else type(pmodel).forward
    bt = batched_cls(pmodel, device="cpu", scan_chunk=4, **KW)
    bt.initialize(np.stack([s[0][0] for s in seqs]), np.stack([s[1][0] for s in seqs]), BOXES0)
    fv, fi, ok = _block(seqs, lengths)
    try:
        setattr(pmodel, fwd.__name__, lambda *a, **k: calls.append(a[1 if cached else 2].shape)
                or orig(pmodel, *a, **k))
        got = bt.track_block(fv, fi, ok)
    finally:
        delattr(pmodel, fwd.__name__)
    assert got.shape == (max(lengths) - 1, 3, 4)
    # one forward per frame over the (2N, ...) stack, not one per sequence
    assert calls == [(6, S_SZ, S_SZ, 3)] * (max(lengths) - 1)
    for j in range(3):
        np.testing.assert_allclose(got[: lengths[j] - 1, j], want[j], rtol=0, atol=1e-3)


def test_batched_matches_jax_batched(pair):
    """The port's cached lockstep tracker against the JAX package's, on the
    same weights and frames, ragged, across template updates."""
    jmodel, variables, pmodel = pair
    lengths = [8, 5, 8]
    seqs = [_seq_frames(lengths[j], 20 + j) for j in range(3)]
    f0v, f0i = np.stack([s[0][0] for s in seqs]), np.stack([s[1][0] for s in seqs])
    fv, fi, ok = _block(seqs, lengths)
    jt = jax_batched.BatchedRGBTCachedTrackerJit(model=jmodel, variables=variables,
                                                 scan_chunk=4, **KW)
    jt.initialize(f0v, f0i, BOXES0)
    want = jt.track_block(fv, fi, ok)
    pt = port_batched.BatchedRGBTCachedTracker(pmodel, device="cpu", scan_chunk=4, **KW)
    pt.initialize(f0v, f0i, BOXES0)
    got = pt.track_block(fv, fi, ok)
    for j in range(3):
        n = lengths[j] - 1
        np.testing.assert_allclose(got[:n, j], want[:n, j], rtol=0, atol=0.02)


def test_non_suffix_mask_raises(pair):
    _, _, pmodel = pair
    seqs = [_seq_frames(4, 40 + j) for j in range(2)]
    bt = port_batched.BatchedRGBTCachedTracker(pmodel, device="cpu", **KW)
    bt.initialize(np.stack([s[0][0] for s in seqs]), np.stack([s[1][0] for s in seqs]),
                  BOXES0[:2])
    fv, fi, _ = _block(seqs, [4, 4])
    ok = np.ones((3, 2), bool)
    ok[1, 0] = False                         # True after a False
    with pytest.raises(ValueError, match="suffix-style"):
        bt.track_block(fv, fi, ok)


def test_frozen_sequence_keeps_state_and_cache(pair):
    """A finished sequence's box, frame count and template cache stay as
    they were while the others run on (and rebuild their caches)."""
    _, _, pmodel = pair
    seqs = [_seq_frames(7, 50 + j) for j in range(2)]
    bt = port_batched.BatchedRGBTCachedTracker(pmodel, device="cpu", **KW)
    bt.initialize(np.stack([s[0][0] for s in seqs]), np.stack([s[1][0] for s in seqs]),
                  BOXES0[:2])
    fv, fi, ok = _block(seqs, [7, 3])
    bt.track_block(fv[:2], fi[:2], ok[:2])
    box1, cache1 = bt._state[1].clone(), bt._cache["kv"][0]["kV"][1].clone()
    bt.track_block(fv[2:], fi[2:], ok[2:])         # frames 3..6: seq 1 frozen
    assert bt._frame_ids.tolist() == [6, 2]
    assert torch.equal(bt._state[1], box1)
    assert torch.equal(bt._cache["kv"][0]["kV"][1], cache1)


def test_run_sequences_batched_writes_results(pair, tmp_path):
    from multi_modal_tracking_torch.eval.data import RGBTSequence
    from multi_modal_tracking_torch.eval.running import run_sequence
    _, _, pmodel = pair
    lengths = [6, 4, 6]
    seqs = []
    for j, n in enumerate(lengths):
        fv, fi = _seq_frames(n, 60 + j)
        gt = np.tile(BOXES0[j].astype(np.float64), (n, 2, 1))
        seqs.append(RGBTSequence(f"s{j}", list(zip(fv, fi)), "LasHeR", gt))
    bt = port_batched.BatchedRGBTCachedTracker(pmodel, device="cpu", **KW)
    stats = port_batched.run_sequences_batched(seqs, bt, str(tmp_path / "b"), chunk=2)
    assert [s["seq"] for s in stats] == ["s0", "s1", "s2"]
    assert port_batched.run_sequences_batched(seqs, bt, str(tmp_path / "b")) == []
    tr = port_tracker.RGBTCachedTracker(pmodel, device="cpu", **KW)
    for seq, st in zip(seqs, stats):
        b = np.loadtxt(tmp_path / "b" / f"{seq.name}.txt")
        t = np.loadtxt(tmp_path / "b" / f"{seq.name}_time.txt")
        assert b.shape == (len(seq.frames), 4) and t.shape == (len(seq.frames),)
        np.testing.assert_array_equal(b, np.trunc(st["boxes"]))
        assert np.isfinite(st["boxes"]).all() and (t > 0).all()
        ref = run_sequence(seq, tr, str(tmp_path / "s"), chunk=4, report_fps=False)
        np.testing.assert_allclose(st["boxes"], ref["boxes"], rtol=0, atol=1e-3)
