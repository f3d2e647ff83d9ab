"""The port's unimodal MixFormer-ViT (models/mixformer.py, the cached path of
models/vit.py) and its trackers against the JAX package's, at a tiny
geometry: depth 2, embed 64, 4 heads (D 16), template 32, search 64 (4 + 4
+ 16 tokens), CORNER_UP head of 64 channels, the SPM score branch.

The JAX model's randomised variables cross to the port through
`from_jax_variables` (strict). Inputs come from numpy seeds; torch runs on
one intra-op thread, JAX at "highest" matmul precision.

Tolerances, f32 on both sides:
  * the model's boxes and score logits, full forward and cached: 1e-4 abs
    (a wrong mask, slot or key moves them by >= 1e-3); the cached path
    against the full forward inside the port: 1e-5;
  * bf16 `_attend` against the JAX package's bf16 `_attend`: both round
    the logits to bf16 and scale them in bf16, take the softmax in f32 and
    round the probabilities and the output to bf16, in the same order; the
    products accumulate in f32 on both sides, in other orders, so an output
    may round the other way: one bf16 unit (2^-8 relative) of the output's
    largest magnitude;
  * the trackers against their JAX twins over 30 frames: the 0.02 px of
    the flagship tracker tests (tests/test_torch_port_tracker.py); scores
    1e-4, `n_filled` and `forget_id` equal;
  * lockstep N = 3 against one stream each: the 0.05 px of the RGB-T
    lockstep tests, the online scores 1e-4 and equal score files.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.models import mixformer as jax_mf
from multi_modal_tracking_tpu.models import vit as jax_vit
from multi_modal_tracking_tpu.tracking import tracker as jax_tracker

from multi_modal_tracking_torch.eval import datasets, evaltracker, run
from multi_modal_tracking_torch.eval.params import get_parameters
from multi_modal_tracking_torch.eval.running import run_sequence
from multi_modal_tracking_torch.models import mixformer as port_mf
from multi_modal_tracking_torch.models import vit as port_vit
from multi_modal_tracking_torch.tracking import batched, tracker
from multi_modal_tracking_torch.utils.convert import from_jax_variables

from tests.test_torch_port_model import _randomise
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

T_SZ, S_SZ = 32, 64
ATOL = 1e-4
TINY = dict(search_size=S_SZ, template_size=T_SZ, embed_dim=64, depth=2, num_heads=4,
            head_type="CORNER_UP", head_dim=64)
#: the score head's last bias: logits on both sides of 0 on the sequences
SCORE_BIAS = ("score_branch", "score_head", "layers_2", "bias")
H, W = 240, 320
N_FRAMES = 31                     # frame 0 initialises, 30 are tracked
KW = dict(template_factor=2.0, template_size=T_SZ, search_factor=4.5, search_size=S_SZ)


@pytest.fixture(scope="module", autouse=True)
def _jax_highest():
    """f32 matmuls in JAX."""
    with jax.default_matmul_precision("highest"):
        yield


def _with_bias(variables, bias):
    """The variables with the score head's last bias set to `bias` (the
    other leaves shared)."""
    out = dict(variables, params=dict(variables["params"]))
    node = out["params"]
    for k in SCORE_BIAS[:-1]:
        node[k] = dict(node[k])
        node = node[k]
    node[SCORE_BIAS[-1]] = np.full_like(node[SCORE_BIAS[-1]], bias)
    return out


def _pair(seed, bias=None):
    """(JAX MixFormer with the score branch, its randomised variables, the
    port model on them in eval mode)."""
    jm = jax_mf.MixFormer(spec=jax_mf.ViTSpec(drop_path_rate=0.0, **TINY), with_score=True)
    t, s = jnp.zeros((1, T_SZ, T_SZ, 3)), jnp.zeros((1, S_SZ, S_SZ, 3))
    variables = _randomise(jax.jit(lambda r: jm.init(r, t, t, s, run_score_head=True))(
        jax.random.PRNGKey(seed)), seed)
    if bias is not None:
        variables = _with_bias(variables, bias)
    pm = port_mf.MixFormer(port_mf.ViTSpec(drop_path_rate=0.0, **TINY), with_score=True).eval()
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, pm


@pytest.fixture(scope="module")
def pair():
    return _pair(2, bias=-1.0)


def _images(seed, b=1, n_ot=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, T_SZ, T_SZ, 3)).astype(np.float32),
            rng.standard_normal((b * n_ot, T_SZ, T_SZ, 3)).astype(np.float32),
            rng.standard_normal((b, S_SZ, S_SZ, 3)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("case", ["full", "cached", "cached_slot_mask", "lockstep_mask"])
def test_model_matches_jax(pair, case):
    """The full forward; set_online / forward_test with no slot mask (the
    cached tracker's ring of one), with a ring of 3 of which 2 slots live
    (the online tracker), and the (B, K) key mask the lockstep twins give
    forward_test; each against JAX. The cached outputs also against the
    port's full forward where the cache holds what the full forward reads."""
    jm, variables, pm = pair
    apply = jax.jit(jm.apply, static_argnames=("method", "run_score_head"))
    set_online, forward_test = "set_online", "forward_test"
    if case == "full":
        t, ot, s = _images(1, b=2)
        want = apply(variables, t, ot, s, run_score_head=True)
        with torch.no_grad():
            got = pm(*_t(t, ot, s), run_score_head=True)
    elif case in ("cached", "cached_slot_mask"):
        n_ot = 1 if case == "cached" else 3
        t, ot, s = _images(2, n_ot=n_ot)
        mask = None if case == "cached" else np.array([1.0, 1.0, 0.0], np.float32)
        cache_j = apply(variables, t, ot, mask, method=set_online)
        want = apply(variables, s, cache_j, run_score_head=True, method=forward_test)
        with torch.no_grad():
            cache = pm.set_online(*_t(t, ot), None if mask is None else torch.from_numpy(mask))
            got = pm.forward_test(torch.from_numpy(s), cache, run_score_head=True)
            np.testing.assert_array_equal(cache["key_mask"].numpy(),
                                          np.asarray(cache_j["key_mask"]))
            full = pm(*_t(t, ot[:1], s), run_score_head=True)
            live = cache if case == "cached" else \
                pm.set_online(*_t(t, ot[:2]), torch.ones(2))
            if case == "cached_slot_mask":     # the masked slot is invisible
                torch.testing.assert_close(got["pred_boxes"], pm.forward_test(
                    torch.from_numpy(s), live, True)["pred_boxes"], atol=1e-5, rtol=0)
            else:
                for k in full:
                    torch.testing.assert_close(got[k], full[k], atol=1e-5, rtol=0)
    else:
        # two streams, rings of 2: stream 0 with one live slot, stream 1
        # with both; the batched cache against each stream's own
        t, ot, s = _images(3, b=2, n_ot=2)
        masks = np.array([[1.0, 0.0], [1.0, 1.0]], np.float32)
        with torch.no_grad():
            cache = pm.set_online(*_t(t, ot), torch.from_numpy(masks))
            assert tuple(cache["key_mask"].shape) == (2, 3 * 4)
            got = pm.forward_test(torch.from_numpy(s), cache, run_score_head=True)
        want = {k: [] for k in got}
        for b in range(2):
            cache_j = apply(variables, t[b:b + 1], ot[2 * b:2 * b + 2], masks[b],
                            method=set_online)
            out = apply(variables, s[b:b + 1], cache_j, run_score_head=True,
                        method=forward_test)
            for k in want:
                want[k].append(np.asarray(out[k]))
        want = {k: np.concatenate(v) for k, v in want.items()}
    assert set(got) == set(want) == {"pred_boxes", "pred_scores"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0,
                                   err_msg=k)


def test_attend_bf16_matches_jax():
    """`_attend` in bf16 with a (B, K) key mask against the JAX package's
    bf16 `_attend` (module docstring)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 4, n, 16)).astype(np.float32) for n in (24, 40, 40))
    mask = np.ones((2, 40), np.float32)
    mask[0, 8:16] = 0.0
    want = np.asarray(jax_vit._attend(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                      0.25, jnp.asarray(mask)).astype(jnp.float32))
    got = port_vit._attend(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), 0.25,
                           torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -8 * np.abs(want).max())
    # the masked keys take no share
    k[0, :, 8:16] += 100.0
    again = port_vit._attend(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), 0.25,
                             torch.from_numpy(mask))
    torch.testing.assert_close(again[0], got[0], atol=0, rtol=0)


# --------------------------------------------------------------- trackers
def _frames(seed, n=N_FRAMES):
    """Textured noise with a bright 48 px square moving 5, 3 px a frame; a
    replicated-grey TIR in which the square is dimmer. Returns (RGB frames,
    TIR frames, RGB box, TIR box): the TIR box is one pixel off, so a mode
    that took the wrong row would start elsewhere."""
    rng = np.random.default_rng(seed)
    fv = rng.integers(0, 120, (n, H, W, 3), dtype=np.uint8)
    fi = rng.integers(0, 120, (n, H, W, 3), dtype=np.uint8)
    for t in range(n):
        x, y = 80 + 5 * t, 60 + 3 * t
        fv[t, y:y + 48, x:x + 48] = 230
        fi[t, y:y + 48, x:x + 48] = 200
        fi[t] = fi[t][..., :1].repeat(3, axis=-1)
    box = np.array([80.0, 60.0, 48.0, 48.0], np.float32)
    return fv, fi, box, box + np.float32(1.0)


#: the score bias of each mode that centres its logits on this sequence, so
#: that candidates are taken and refused
MODE_BIAS = {"RGB": -1.1, "TIR": -0.31, "Prompt": -0.91}
#: (JAX class, port class, extra settings); update interval 7: commits at
#: frames 7, 14, 21 and 28, the ring growing 1 -> 2 -> 3 then replacing
TRACKERS = {"full": (jax_tracker.RGBTrackerJit, tracker.RGBTracker, {}),
            "cached": (jax_tracker.RGBCachedTrackerJit, tracker.RGBCachedTracker, {}),
            "online": (jax_tracker.OnlineTrackerJit, tracker.OnlineTracker,
                       dict(online_size=3, max_score_decay=0.9))}


@pytest.mark.parametrize("mode", ["RGB", "TIR", "Prompt"])
@pytest.mark.parametrize("which", list(TRACKERS))
def test_tracker_matches_jax(pair, which, mode):
    jm, variables, pm = pair
    jax_cls, port_cls, extra = TRACKERS[which]
    if which == "online":
        variables = _with_bias(variables, MODE_BIAS[mode])
        pm = copy.deepcopy(pm)
        pm.load_state_dict(from_jax_variables(variables))
    fv, fi, box_v, box_i = _frames(0)
    init = {"init_bbox": [box_v, box_i]}
    jt = jax_cls(model=jm, variables=variables, update_interval=7, mode=mode, **KW, **extra)
    pt = port_cls(pm, update_interval=7, mode=mode, device="cpu", **KW, **extra)
    jt.initialize([fv[0], fi[0]], init)
    pt.initialize([fv[0], fi[0]], init)
    want, got, rings = [], [], []
    for k in range(1, N_FRAMES):
        want.append(jt.track([fv[k], fi[k]]))
        got.append(pt.track([fv[k], fi[k]]))
        if which == "online":
            rings.append(((int(jt._state.n_filled), int(jt._state.forget_id)),
                          (int(pt._n_filled), int(pt._forget_id))))
    np.testing.assert_allclose([g["target_bbox"] for g in got],
                               [w["target_bbox"] for w in want], atol=0.02, rtol=0)
    if which == "online":
        scores = np.array([w["pred_score"] for w in want])
        np.testing.assert_allclose([g["pred_score"] for g in got], scores, atol=1e-4, rtol=0)
        assert (scores > 0.5).any() and (scores < 0.5).any(), scores
        assert [r[1] for r in rings] == [r[0] for r in rings]
        assert rings[-1][1] == (3, 2)                # two appends, then two replacements
        # the same slots hold a taken candidate (not the base template)
        taken = [not torch.equal(pt._ring[j], pt._template[0]) for j in range(3)]
        jring, jt0 = np.asarray(jt._state.online_template_v), np.asarray(jt._state.template_v)
        assert taken == [not np.array_equal(jring[j], jt0[0]) for j in range(3)] and any(taken)
    assert not np.allclose(got[-1]["target_bbox"], got[0]["target_bbox"])


def test_chunked_equals_per_frame_and_modes_upload(pair):
    """track_chunk gives track's bits (boxes, scores, the ring); an RGB
    sequence's frames (an array, not a pair) serve every mode; the ROI
    upload mode raises."""
    _, _, pm = pair
    fv, fi, box, _ = _frames(1, n=9)
    kw = dict(KW, update_interval=3, online_size=2, device="cpu")
    a, b = tracker.OnlineTracker(pm, **kw), tracker.OnlineTracker(pm, **kw)
    a.initialize(fv[0], {"init_bbox": box})
    want = [a.track(fv[k]) for k in range(1, 9)]
    b.initialize([fv[0]], {"init_bbox": box})
    boxes, scores = b.track_chunk(fv[1:])
    np.testing.assert_array_equal(boxes, np.float32([w["target_bbox"] for w in want]))
    np.testing.assert_array_equal(scores, np.float32([w["pred_score"] for w in want]))
    assert torch.equal(a._ring, b._ring) and int(b._n_filled) == 2
    with pytest.raises(NotImplementedError, match="item 1"):
        b.track_chunk_roi(fv[1:], fv[1:], (0, 0))
    with pytest.raises(ValueError, match="mode"):
        tracker.RGBTracker(pm, mode="RGBT", device="cpu")


# --------------------------------------------------------------- lockstep
def _sequences(n_frames=(10, 8, 7)):
    """Three RGB-T sequences of different lengths (the shorter ones frozen
    at their end in lockstep)."""
    from multi_modal_tracking_torch.eval.data import RGBTSequence
    out = []
    for j, n in enumerate(n_frames):
        fv, fi, box, _ = _frames(10 + j, n)
        gt = np.repeat(box[None], n, 0)
        out.append(RGBTSequence(f"s{j}", list(zip(fv, fi)), "synthetic",
                                np.stack([gt, gt], axis=1)))
    return out


@pytest.mark.parametrize("twin,single,mode", [
    (batched.BatchedRGBTracker, tracker.RGBTracker, "RGB"),
    (batched.BatchedRGBCachedTracker, tracker.RGBCachedTracker, "TIR"),
    (batched.BatchedOnlineTracker, tracker.OnlineTracker, "Prompt"),
])
def test_lockstep_twin_matches_one_stream(pair, tmp_path, twin, single, mode):
    """Each lockstep twin at N = 3 (streams of 10, 8 and 7 frames) through
    run_sequences_batched against run_sequence of each stream alone:
    boxes, scores and score files."""
    _, _, pm = pair
    seqs = _sequences()
    extra = dict(online_size=2, max_score_decay=0.9) if single is tracker.OnlineTracker else {}
    kw = dict(KW, update_interval=3, mode=mode, device="cpu", **extra)
    alone = [run_sequence(s, single(pm, **kw), str(tmp_path / "one"), chunk=4,
                          report_fps=False) for s in seqs]
    both = batched.run_sequences_batched(seqs, twin(pm, scan_chunk=4, **kw),
                                         str(tmp_path / "lock"))
    for a, b in zip(alone, both):
        assert a["seq"] == b["seq"] and a["n_frames"] == b["n_frames"]
        np.testing.assert_allclose(b["boxes"], a["boxes"], atol=0.05, rtol=0)
        if "scores" in a:
            np.testing.assert_allclose(b["scores"], a["scores"], atol=1e-4, rtol=0)
            for d in ("one", "lock"):
                assert os.path.isfile(tmp_path / d / f"{a['seq']}_score.txt")
            assert (tmp_path / "one" / f"{a['seq']}_score.txt").read_bytes() == \
                (tmp_path / "lock" / f"{a['seq']}_score.txt").read_bytes()


# ---------------------------------------------------------------- eval CLI
@pytest.fixture
def tiny_build(monkeypatch):
    """create_tracker's models at the tiny geometry."""
    orig = evaltracker.build_model
    monkeypatch.setattr(evaltracker, "build_model", lambda *a, **kw: orig(
        *a, spec_overrides=dict(TINY, drop_path_rate=0.0), **kw))


@pytest.fixture
def tiny_cli(monkeypatch, tiny_build):
    """eval.run with the tiny geometry and the datasets cut to 3 sequences
    of 8 frames."""
    orig_params = run.get_parameters

    def params(*a, **kw):
        p = orig_params(*a, **kw)
        p.template_size, p.search_size = T_SZ, S_SZ
        p.cfg.DATA.TEMPLATE.SIZE, p.cfg.DATA.SEARCH.SIZE = T_SZ, S_SZ
        return p
    monkeypatch.setattr(run, "get_parameters", params)
    monkeypatch.setattr(run, "get_dataset", lambda name: datasets.get_dataset(
        name, n_sequences=3, n_frames=8))


def test_eval_run_type_tir_and_synthetic_rgb(tiny_cli, tmp_path):
    """`eval.run mixformer_vit_online baseline --dataset_name
    synthetic_rgbt_hard --type TIR`, one stream and --batch_sequences 3:
    result and score files for every sequence, the lockstep files within a
    pixel of the one-stream ones (the files hold integers); then
    `mixformer_vit baseline` on the unimodal synthetic_rgb."""
    base = ["mixformer_vit_online", "baseline", "--dataset_name", "synthetic_rgbt_hard",
            "--type", "TIR", "--device", "cpu", "--dtype", "float32", "--chunk", "4"]
    one = run.main(base + ["--results_dir", str(tmp_path / "one")])[0]
    lock = run.main(base + ["--results_dir", str(tmp_path / "lock"),
                            "--batch_sequences", "3"])[0]
    for k in range(3):
        name = f"synthetic_hard_{k:02d}"
        a, b = (np.loadtxt(os.path.join(d, f"{name}.txt")) for d in (one, lock))
        assert a.shape == (8, 4) and np.abs(a - b).max() <= 1
        for d in (one, lock):
            scores = np.loadtxt(os.path.join(d, f"{name}_score.txt"))
            assert scores.shape == (8,) and scores[0] == 1.0
    out = run.main(["mixformer_vit", "baseline", "--dataset_name", "synthetic_rgb", "--device",
                    "cpu", "--dtype", "float32", "--results_dir", str(tmp_path / "rgb")])[0]
    seqs = datasets.get_dataset("synthetic_rgb", n_sequences=3, n_frames=8)
    assert isinstance(seqs[0].frames[0], np.ndarray) and seqs[0].frames[0].shape == (H, W, 3)
    for s in seqs:
        boxes = np.loadtxt(os.path.join(out, f"{s.name}.txt"))
        assert boxes.shape == (8, 4) and np.array_equal(boxes[0], s.ground_truth_rect[0])


def test_create_tracker_picks_as_jax(tiny_build):
    """create_tracker's choice (eval/evaltracker.py:97-112 there): the
    online script's OnlineTracker with the dataset's online size, the
    cached tracker for mixformer_vit, RGBT meaning RGB; the CLI's twins."""
    params = get_parameters("mixformer_vit_online", "baseline")
    assert params.search_factor == 4.5 and params.cfg.TEST.SEARCH_SIZE == 288
    for name, size in (("got10k_test", 2), ("trackingnet", 3), ("synthetic_rgbt_hard", 3)):
        t = evaltracker.create_tracker(params, name, device="cpu", dtype=torch.float32,
                                       mode="TIR")
        assert type(t) is tracker.OnlineTracker and t.online_size == size and t.mode == "TIR"
    twin = run._batched_twin(t, 4)
    assert type(twin) is batched.BatchedOnlineTracker and twin.online_size == 3 \
        and twin.mode == "TIR" and twin.model is t.model
    t = evaltracker.create_tracker(get_parameters("mixformer_vit", "baseline"), "lasot",
                                   device="cpu", dtype=torch.float32)
    assert type(t) is tracker.RGBCachedTracker and t.mode == "RGB" and t.update_interval == 200
    assert type(run._batched_twin(t, 4)) is batched.BatchedRGBCachedTracker
