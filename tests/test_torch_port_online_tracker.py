"""The port's score-gated online trackers (asymmetric_shared_online) on the
CPU against the JAX package's: `RGBTOnlineTracker` against
`RGBTOnlineTrackerJit`, `RGBTOnlineCachedTracker` against
`RGBTOnlineCachedTrackerJit`, each through its package's own sequence
runner, on the scored tiny flagship of tests/test_torch_port_spm.py and
the moving-square sequence of tests/test_torch_port_tracker.py (8 frames,
update interval 3: commits at frames 3 and 6).

The score head's last bias is set so that some frames score above 0.5 (a
candidate is taken, and committed) and some below; the tests assert both.
Tolerances: boxes within the 0.02 px of tests/test_torch_port_tracker.py,
scores within 1e-4; the `<seq>_score.txt` files (`%.2f`) byte-equal. The
lockstep twins are held to one stream within the 0.05 px of the eval
phase of chip_smoke.py, with equal score files.
"""
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.eval import running as jax_running
from multi_modal_tracking_tpu.eval.data import RGBTSequence as JaxRGBTSequence
from multi_modal_tracking_tpu.tracking import tracker as jax_tracker

from multi_modal_tracking_torch.eval import running
from multi_modal_tracking_torch.eval.data import RGBTSequence
from multi_modal_tracking_torch.tracking import batched, tracker
from multi_modal_tracking_torch.tracking.graphs import leaves

from tests.test_torch_port_batched import one_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_port_model import S_SZ, T_SZ
from tests.test_torch_port_spm import score_pair

H, W = 240, 320
N_FRAMES = 8
#: the score head's last bias: logits on both sides of 0 on this sequence
SCORE_BIAS = 0.45
KW = dict(template_factor=2.0, template_size=T_SZ, search_factor=4.5, search_size=S_SZ,
          update_interval=3)


def _sequence(name, seed, n=N_FRAMES):
    """Textured noise with a bright 48 px square moving 5, 3 px a frame;
    replicated-gray TIR. Returns (port sequence, JAX sequence)."""
    rng = np.random.default_rng(seed)
    fv = rng.integers(0, 120, (n, H, W, 3), dtype=np.uint8)
    fi = rng.integers(0, 120, (n, H, W, 3), dtype=np.uint8)
    gt = np.zeros((n, 4))
    for t in range(n):
        x, y = 80 + 5 * t, 60 + 3 * t
        fv[t, y:y + 48, x:x + 48] = 230
        fi[t, y:y + 48, x:x + 48] = 200
        fi[t] = fi[t][..., :1].repeat(3, axis=-1)
        gt[t] = (x, y, 48, 48)
    frames = [(fv[t], fi[t]) for t in range(n)]
    boxes = np.stack([gt, gt], axis=1)
    return (RGBTSequence(name, frames, "LasHeR", boxes),
            JaxRGBTSequence(name, frames, "LasHeR", boxes))


@pytest.fixture(scope="module")
def pair():
    return score_pair(3, bias=SCORE_BIAS)


class _PerFrame:
    """A JAX tracker seen through initialize / track only (the runner's
    per-frame path), recording each frame's floats."""

    def __init__(self, jt):
        self.jt, self.boxes, self.scores = jt, [], []

    def initialize(self, image, info):
        self.jt.initialize(image, info)

    def track(self, image, info=None):
        out = self.jt.track(image, info)
        self.boxes.append(out["target_bbox"])
        self.scores.append(out["pred_score"])
        return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("jax_cls,port_cls,decay", [
    (jax_tracker.RGBTOnlineCachedTrackerJit, tracker.RGBTOnlineCachedTracker, 1.0),
    (jax_tracker.RGBTOnlineTrackerJit, tracker.RGBTOnlineTracker, 0.8),
], ids=["cached", "full_decay"])
def test_online_trajectory_and_scores_match_jax(pair, tmp_path, jax_cls, port_cls, decay):
    jmodel, variables, pmodel = pair
    seq, jseq = _sequence("online", 0)
    jt = _PerFrame(jax_cls(model=jmodel, variables=variables, max_score_decay=decay, **KW))
    jax_running.run_sequence(jseq, jt, str(tmp_path / "jax"), report_fps=False)
    pt = port_cls(pmodel, device="cpu", max_score_decay=decay, **KW)
    st = running.run_sequence(seq, pt, str(tmp_path / "port"), chunk=4, report_fps=False)

    want_scores = np.asarray(jt.scores)
    np.testing.assert_allclose(st["boxes"][1:], np.asarray(jt.boxes), atol=0.02, rtol=0)
    np.testing.assert_allclose(st["scores"][1:], want_scores, atol=1e-4, rtol=0)
    assert st["scores"][0] == 1.0
    assert (want_scores > 0.5).any() and (want_scores < 0.5).any(), want_scores
    # the commits at frames 3 and 6 installed a taken candidate, not the base
    assert not torch.equal(pt._online, pt._template)
    assert not np.array_equal(np.asarray(jt.jt._state.online_template_v),
                              np.asarray(jt.jt._state.template_v))
    for name in ("online_score.txt", "online.txt"):
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "jax" / name), name


def test_per_frame_equals_chunked_and_snapshot(pair, tmp_path):
    """track and track_chunk give the same bits (boxes, scores and every
    state buffer); snapshot / restore take the whole state back."""
    _, _, pmodel = pair
    seq, _ = _sequence("s", 1)
    fv = np.stack([f[0] for f in seq.frames])
    fi = np.stack([f[1] for f in seq.frames])
    a = tracker.RGBTOnlineCachedTracker(pmodel, device="cpu", **KW)
    a.initialize([fv[0], fi[0]], seq.init_info())
    snap = a.snapshot()
    outs = [a.track([fv[k], fi[k]]) for k in range(1, N_FRAMES)]
    end = a.snapshot()
    a.restore(snap)
    boxes, scores = a.track_chunk(fv[1:], fi[1:])
    np.testing.assert_array_equal(boxes, np.asarray([o["target_bbox"] for o in outs], np.float32))
    np.testing.assert_array_equal(scores, np.asarray([o["pred_score"] for o in outs], np.float32))
    for k in a._STATE:
        for x, y in zip(*(leaves(s[k]) for s in (a.snapshot(), end)), strict=True):
            assert torch.equal(x, y), k
    with pytest.raises(NotImplementedError, match="item 1"):
        a.track_chunk_roi(fv[1:], fi[1:], (0, 0))
    with pytest.raises(NotImplementedError, match="item 1"):
        running.run_sequence(seq, a, str(tmp_path), roi_margin=1.5)


@pytest.mark.parametrize("single_cls,twin_cls", [
    (tracker.RGBTOnlineCachedTracker, batched.BatchedRGBTOnlineCachedTracker),
    (tracker.RGBTOnlineTracker, batched.BatchedRGBTOnlineTracker),
], ids=["cached", "full"])
def test_lockstep_twin_matches_one_stream(pair, tmp_path, single_cls, twin_cls):
    """Two sequences in lockstep, one cut short at 5 frames (frozen from
    then on), against each tracked alone: boxes within 0.05 px, scores
    within 1e-4, score files equal."""
    _, _, pmodel = pair
    seqs = [_sequence(f"seq_{i}", 2 + i)[0] for i in range(2)]
    seqs[1].frames, seqs[1].ground_truth_rect = seqs[1].frames[:5], seqs[1].ground_truth_rect[:5]
    single = single_cls(pmodel, device="cpu", max_score_decay=0.9, **KW)
    one = {s.name: running.run_sequence(s, single, str(tmp_path / "one"), chunk=4,
                                        report_fps=False) for s in seqs}
    twin = twin_cls(pmodel, device="cpu", max_score_decay=0.9, scan_chunk=4, **KW)
    got = batched.run_sequences_batched(seqs, twin, str(tmp_path / "twin"), chunk=3)
    for st in got:
        want = one[st["seq"]]
        np.testing.assert_allclose(st["boxes"], want["boxes"], atol=0.05, rtol=0)
        np.testing.assert_allclose(st["scores"], want["scores"], atol=1e-4, rtol=0)
        name = f"{st['seq']}_score.txt"
        assert _read(tmp_path / "twin" / name) == _read(tmp_path / "one" / name)
    scores = np.concatenate([st["scores"][1:] for st in got])
    assert (scores > 0.5).any() and (scores < 0.5).any()


def test_create_tracker_and_cli_twin_are_online(monkeypatch):
    """create_tracker gives the cached online tracker for the online script
    (max_score_decay from the config), the CLI's lockstep twin the online
    one, and every other script the plain cached tracker."""
    from multi_modal_tracking_torch.eval import evaltracker, run
    from multi_modal_tracking_torch.eval.params import get_parameters
    orig = evaltracker.build_model
    tiny = dict(embed_dim=32, depth=1, num_heads=2, head_dim=32, fusion_layers=1)
    monkeypatch.setattr(evaltracker, "build_model",
                        lambda *a, **kw: orig(*a, spec_overrides=tiny, **kw))
    params = get_parameters("asymmetric_shared_online", "attention_lasher_newfusion_2layer")
    params.cfg.TEST.MAX_SCORE_DECAY = 0.97
    t = evaltracker.create_tracker(params, "TRACKINGNET", device="cpu", dtype=torch.float32)
    assert type(t) is tracker.RGBTOnlineCachedTracker
    assert t.max_score_decay == 0.97 and t.update_interval == 25 and t.model.with_score
    twin = run._batched_twin(t, 4)
    assert type(twin) is batched.BatchedRGBTOnlineCachedTracker and twin.max_score_decay == 0.97
    assert evaltracker.online_size_decay(params.cfg, "lasher") == (3, 0.97)
    ce = evaltracker.create_tracker(get_parameters("asymmetric_shared_ce",
                                                   "attention_lasher_newfusion_2layer"),
                                    device="cpu", dtype=torch.float32)
    assert type(ce) is tracker.RGBTCachedTracker
    assert type(run._batched_twin(ce, 4)) is batched.BatchedRGBTCachedTracker
