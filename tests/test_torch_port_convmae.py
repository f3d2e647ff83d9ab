"""The port's MixFormer-ConvMAE (models/convmae.py) and its trackers, stage-2
training step, parameter groups, recipes and checkpoints against the JAX
package's, at a tiny geometry: widths 32 / 48 / 64, depths 1 / 1 / 2, 4
heads, template 32, search 64 (4 + 4 + 16 stage-3 tokens), the CORNER_UP
head of 64 channels, the SPM score branch.

The helpers and the tolerances are tests/test_torch_port_cvt.py's (module
docstring there); the box step is its, stage 2 is here.
"""
import copy
import os
import sys

import jax
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.config import get_default_config as jax_default_config
from multi_modal_tracking_tpu.models import convmae as jax_cm
from multi_modal_tracking_tpu.tracking import tracker as jax_tracker

from multi_modal_tracking_torch.config import get_default_config
from multi_modal_tracking_torch.eval import datasets, evaltracker, run
from multi_modal_tracking_torch.eval.params import get_parameters
from multi_modal_tracking_torch.eval.running import run_sequence
from multi_modal_tracking_torch.models import convmae as port_cm
from multi_modal_tracking_torch.models.build import build_model
from multi_modal_tracking_torch.tracking import batched, tracker
from multi_modal_tracking_torch.tracking.graphs import leaves
from multi_modal_tracking_torch.train import optimizer as port_opt
from multi_modal_tracking_torch.utils.checkpoint import load_variables
from multi_modal_tracking_torch.utils.convert import from_jax_variables

from tests.test_torch_port_cvt import (_close, _cfg, _images, _jax_count, _jax_groups, _t,
                                       full_width_matches_jax, jax_cached, jax_variables,
                                       step_matches_jax)
from tests.test_torch_port_cvt import _jax_highest  # noqa: F401 (autouse fixture)
from tests.test_torch_port_unimodal import KW, S_SZ, T_SZ, _frames, _sequences, _with_bias
from tests.test_torch_port_unimodal_train import argparse_namespace
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-4
TINY = dict(search_size=S_SZ, template_size=T_SZ, embed_dim=(32, 48, 64), depth=(1, 1, 2),
            num_heads=4, head_type="CORNER_UP", head_dim=64, drop_path_rate=0.0)
N_FRAMES = 13
RECIPES = {"mixformer_convmae": ("baseline", "baseline_got", "baseline_large"),
           "mixformer_convmae_online": ("baseline", "baseline_got", "baseline_large")}


def _port(variables, score=True, **spec):
    pm = port_cm.MixFormerConvMAE(port_cm.ConvMAESpec(**dict(TINY, **spec)),
                                  with_score=score).eval()
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return pm


@pytest.fixture(scope="module")
def pair():
    """(JAX MixFormerConvMAE with the score branch, its variables with the
    score bias centred on the tracking sequence, the port model on them)."""
    jm = jax_cm.MixFormerConvMAE(spec=jax_cm.ConvMAESpec(**TINY), with_score=True)
    variables = jax_variables(jm, 5)
    pm = _port(variables)
    fv, _, box, _ = _frames(0)
    probe = tracker.OnlineTracker(pm, update_interval=4, online_size=3, device="cpu", **KW)
    probe.initialize(fv[0], {"init_bbox": box})
    s = np.array([probe.track(fv[k])["pred_score"] for k in range(1, N_FRAMES)])
    bias = float(variables["params"]["score_branch"]["score_head"]["layers_2"]["bias"][0])
    variables = _with_bias(variables, bias - float(np.median(np.log(s / (1 - s)))))
    pm.load_state_dict(from_jax_variables(variables))
    return jm, variables, pm


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("case", ["full", "cached", "cached_slot_mask", "batched_streams"])
def test_model_matches_jax(pair, case):
    """As tests/test_torch_port_cvt.py's: the full forward (K1's plain
    version in each stage-3 block) against JAX; the cached path against the
    port's full forward (1e-5); a ring of 3 with 2 live slots against JAX
    (outputs, the key mask and every cached k and v) and against a ring of
    the live slots; N = 3 streams against single-stream calls and JAX."""
    jm, variables, pm = pair
    with torch.no_grad():
        if case == "full":
            t, ot, s = _images(1, b=2)
            want = jax.jit(lambda v, a, b, c: jm.apply(v, a, b, c, run_score_head=True))(
                variables, t, ot, s)
            _close({k: v.numpy() for k, v in pm(*_t(t, ot, s), run_score_head=True).items()},
                   want)
        elif case == "cached":
            t, ot, s = _images(2)
            got = pm.forward_test(torch.from_numpy(s), pm.set_online(*_t(t, ot)), True)
            full = pm(*_t(t, ot, s), run_score_head=True)
            _close({k: v.numpy() for k, v in got.items()},
                   {k: v.numpy() for k, v in full.items()}, 1e-5)
        elif case == "cached_slot_mask":
            t, ot, s = _images(3, n_ot=3)
            mask = np.array([1.0, 1.0, 0.0], np.float32)
            cache_j, want = jax_cached(jm)(variables, t, ot, mask, s)
            cache = pm.set_online(*_t(t, ot), torch.from_numpy(mask))
            got = pm.forward_test(torch.from_numpy(s), cache, run_score_head=True)
            _close({k: v.numpy() for k, v in got.items()}, want)
            np.testing.assert_array_equal(cache["key_mask"].numpy(), cache_j["key_mask"])
            mem = leaves(cache["mem"])
            assert len(mem) == len(jax.tree_util.tree_leaves(cache_j["mem"])) == 2 * 2
            for a, b in zip(jax.tree_util.tree_leaves(cache_j["mem"]), mem):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)
            live = pm.forward_test(torch.from_numpy(s), pm.set_online(
                *_t(t, ot[:2]), torch.ones(2)), run_score_head=True)
            _close({k: v.numpy() for k, v in got.items()},
                   {k: v.numpy() for k, v in live.items()}, 1e-5)
        else:
            t, ot, s = _images(4, b=3, n_ot=3)
            masks = np.array([[1.0, 1.0, 1.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0]], np.float32)
            got = pm.forward_test(torch.from_numpy(s), pm.set_online(
                *_t(t, ot), torch.from_numpy(masks)), run_score_head=True)
            cached = jax_cached(jm)
            for b in range(3):
                one = pm.forward_test(torch.from_numpy(s[b:b + 1]), pm.set_online(
                    *_t(t[b:b + 1], ot[3 * b:3 * b + 3]), torch.from_numpy(masks[b])), True)
                _close({k: v[b:b + 1].numpy() for k, v in got.items()},
                       {k: v.numpy() for k, v in one.items()}, 1e-5)
                _close({k: v[b:b + 1].numpy() for k, v in got.items()},
                       cached(variables, t[b:b + 1], ot[3 * b:3 * b + 3], masks[b],
                              s[b:b + 1])[1])


# --------------------------------------------------------------- trackers
TRACKERS = {"cached": (jax_tracker.RGBCachedTrackerJit, tracker.RGBCachedTracker, {}),
            "online": (jax_tracker.OnlineTrackerJit, tracker.OnlineTracker,
                       dict(online_size=3, max_score_decay=0.9))}


@pytest.mark.parametrize("which,mode", [("cached", "RGB")])
def test_tracker_matches_jax(pair, which, mode):
    """The cached tracker against its JAX twin over 12 frames at update
    interval 4 (the online one is tests/test_torch_port_cvt.py's)."""
    jm, variables, pm = pair
    jax_cls, port_cls, extra = TRACKERS[which]
    fv, fi, box_v, box_i = _frames(0, n=N_FRAMES)
    init = {"init_bbox": [box_v, box_i]}
    jt = jax_cls(model=jm, variables=variables, update_interval=4, mode=mode, **KW, **extra)
    pt = port_cls(pm, update_interval=4, mode=mode, device="cpu", **KW, **extra)
    jt.initialize([fv[0], fi[0]], init)
    pt.initialize([fv[0], fi[0]], init)
    want, got = [], []
    for k in range(1, N_FRAMES):
        want.append(jt.track([fv[k], fi[k]]))
        got.append(pt.track([fv[k], fi[k]]))
    np.testing.assert_allclose([g["target_bbox"] for g in got],
                               [w["target_bbox"] for w in want], atol=0.02, rtol=0)
    if which == "online":
        scores = np.array([w["pred_score"] for w in want])
        np.testing.assert_allclose([g["pred_score"] for g in got], scores, atol=1e-4, rtol=0)
        assert (int(pt._n_filled), int(pt._forget_id)) == \
            (int(jt._state.n_filled), int(jt._state.forget_id)) == (3, 1)
    assert not np.allclose(got[-1]["target_bbox"], got[0]["target_bbox"])


@pytest.mark.parametrize("twin,single,mode", [
    (batched.BatchedRGBCachedTracker, tracker.RGBCachedTracker, "Prompt"),
    (batched.BatchedOnlineTracker, tracker.OnlineTracker, "RGB"),
])
def test_lockstep_twin_matches_one_stream(pair, tmp_path, twin, single, mode):
    """Each lockstep twin at N = 3 against run_sequence of each stream
    alone: boxes 0.05 px, scores 1e-4, the same score files."""
    _, _, pm = pair
    seqs = _sequences()
    extra = dict(online_size=2, max_score_decay=0.9) if single is tracker.OnlineTracker else {}
    kw = dict(KW, update_interval=3, mode=mode, device="cpu", **extra)
    alone = [run_sequence(s, single(pm, **kw), str(tmp_path / "one"), chunk=4,
                          report_fps=False) for s in seqs]
    both = batched.run_sequences_batched(seqs, twin(pm, scan_chunk=4, **kw),
                                         str(tmp_path / "lock"))
    for a, b in zip(alone, both):
        np.testing.assert_allclose(b["boxes"], a["boxes"], atol=0.05, rtol=0)
        if "scores" in a:
            np.testing.assert_allclose(b["scores"], a["scores"], atol=1e-4, rtol=0)
            assert (tmp_path / "one" / f"{a['seq']}_score.txt").read_bytes() == \
                (tmp_path / "lock" / f"{a['seq']}_score.txt").read_bytes()


# ------------------------------------------------------------------- train
def test_stage2_step_matches_jax(pair):
    """Stage 2 of mixformer_convmae_online's baseline (TRAIN_SCORE) on a
    copy of the module's model: the net in eval mode (its head's BN on the
    running statistics, as the recipe's frozen BN), the gradients of every
    parameter (the clip's norm covers them), only the score branch
    updated."""
    jm, variables, pm = pair
    pm = copy.deepcopy(pm)
    # a batch whose gradients the clip scales (their norm is above 0.1)
    opt = step_matches_jax(jm, variables, pm, "mixformer_convmae_online", seed=10)
    trained = {id(p) for p in opt.groups["main"]}
    assert set(opt.groups) == {"main"} and trained == \
        {id(p) for n, p in pm.named_parameters() if n.startswith("score_branch.")}


@pytest.mark.parametrize("script", ["mixformer_convmae", "mixformer_convmae_online"],
                         ids=["default", "train_score"])
def test_param_groups_match_jax(pair, script):
    """Every parameter's group and multiplier against the JAX package's
    `_regime_labeler`: the default regime (the backbone at
    BACKBONE_MULTIPLIER, the head at 1.0, the score branch frozen) and
    TRAIN_SCORE."""
    _, variables, pm = pair
    jcfg, pcfg = _cfg(jax_default_config, script), _cfg(get_default_config, script)
    want = _jax_groups(jcfg, variables)
    opt = port_opt.make_optimizer(pcfg, pm)
    ids = {id(p): n for n, p in pm.named_parameters()}
    got = {n: "frozen" for n in ids.values()}
    for g, ps in opt.groups.items():
        for p in ps:
            got[ids[id(p)]] = g
    assert got == want
    if script == "mixformer_convmae":
        assert opt.mults == {"main": 1.0, "backbone": 0.1}


# ------------------------------------------------------------------ build
@pytest.mark.parametrize("script", list(RECIPES))
def test_every_recipe_builds_on_meta(script):
    """All ConvMAE recipes build at full width on the meta device: base
    (256 / 384 / 768, 2 / 2 / 11, 12 heads, 128 / 288) and large (384 / 768
    / 1024, 2 / 2 / 20, 16 heads, 192 / 384), CORNER_UP; the online
    script's base and large parameters against jax.eval_shape of the JAX
    model, tensor by tensor."""
    for recipe in RECIPES[script]:
        cfg = _cfg(get_default_config, script, recipe)
        with torch.device("meta"):
            pm = port_cm.build_mixformer_convmae(cfg, with_score=script.endswith("online"))
        large = cfg.MODEL.VIT_TYPE == "convmae_large"
        assert pm.spec.depth == ((2, 2, 20) if large else (2, 2, 11))
        assert pm.box_head.feat_sz == cfg.DATA.SEARCH.SIZE // 4
        if script.endswith("online") and recipe in ("baseline", "baseline_large"):
            jcfg = _cfg(jax_default_config, script, recipe)
            shapes = _jax_count(jax_cm.build_mixformer_convmae(jcfg, with_score=True), jcfg)
            n, _ = full_width_matches_jax(pm, shapes, True)
            assert n > (250e6 if large else 80e6)


def test_build_model_is_seeded():
    """build_model's init_random covers every parameter and buffer from the
    seed: one seed twice gives the same bits, another seed other values in
    every weight matrix and kernel; frozen BNs keep their identity
    statistics."""
    cfg = get_default_config("mixformer_convmae_online")
    a, b, c = (build_model("mixformer_convmae_online", cfg, device="cpu", seed=seed, spec_overrides=TINY)
               for seed in (3, 3, 4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(not torch.equal(p, sc[k]) for k, p in a.named_parameters() if p.dim() > 1)
    for name, m in a.named_modules():
        if type(m).__name__ == "FrozenBatchNorm2d":
            assert torch.equal(m.running_var, torch.ones_like(m.running_var)), name


# ------------------------------------------------------------- checkpoints
def test_checkpoints_load(pair, tmp_path):
    """A reference-format `.pth.tar` loads strictly, the same bits; a bare
    ConvMAE pretrain dict (`patch_embed1.*`, `blocks1.*`, ..., with the
    pretrain's final `norm` and a position embedding) gets the `backbone.`
    prefix and loads non-strictly: the backbone's tensors taken, the norm
    unused."""
    _, variables, pm = pair
    want = from_jax_variables(variables)
    path = str(tmp_path / "MixFormerOnlineScore_ep0040.pth.tar")
    torch.save({"net": {f"module.{k}": v for k, v in want.items()},
                "settings": argparse_namespace(), "epoch": 40}, path)
    fresh = port_cm.MixFormerConvMAE(port_cm.ConvMAESpec(**TINY), with_score=True)
    report = load_variables(path, fresh, strict=True)
    got = fresh.state_dict()
    assert report["loaded"] == len(got) and all(torch.equal(got[k], want[k]) for k in want)
    bare = {k[len("backbone."):]: v + 1 for k, v in want.items() if k.startswith("backbone.")}
    extras = {"norm.weight": torch.ones(64), "norm.bias": torch.zeros(64)}
    path = str(tmp_path / "convmae_base.pth")
    torch.save({"model": dict(bare, pos_embed=torch.zeros(1, 16, 64), **extras)}, path)
    report = load_variables(path, fresh, strict=True)
    got = fresh.state_dict()
    assert report["loaded"] == len(bare) and sorted(report["unexpected"]) == \
        sorted("backbone." + k for k in extras)
    assert all(torch.equal(got["backbone." + k], v) for k, v in bare.items())


# ------------------------------------------------------------ entry points
@pytest.fixture
def tiny_cli(monkeypatch):
    orig, orig_params = evaltracker.build_model, run.get_parameters
    monkeypatch.setattr(evaltracker, "build_model", lambda *a, **kw: orig(
        *a, spec_overrides=TINY, **kw))

    def params(*a, **kw):
        p = orig_params(*a, **kw)
        p.template_size, p.search_size = T_SZ, S_SZ
        return p
    monkeypatch.setattr(run, "get_parameters", params)
    monkeypatch.setattr(run, "get_dataset", lambda name: datasets.get_dataset(
        name, n_sequences=3, n_frames=8))


def test_create_tracker_and_eval_run(tiny_cli, tmp_path):
    """create_tracker picks as the JAX package does (ConvMAE's own tree: the
    search factor of its recipe, no tracking overlay); `eval.run
    mixformer_convmae baseline --batch_sequences 3` (the cached lockstep
    twin) within a pixel of one stream."""
    params = get_parameters("mixformer_convmae", "baseline")
    assert params.cfg.MODEL.VIT_TYPE == "convmae_base" and params.search_size == 288
    t = evaltracker.create_tracker(params, "lasot", device="cpu", dtype=torch.float32)
    assert type(t) is tracker.RGBCachedTracker
    assert type(run._batched_twin(t, 4)) is batched.BatchedRGBCachedTracker
    t = evaltracker.create_tracker(get_parameters("mixformer_convmae_online", "baseline"),
                                   "lasot", device="cpu", dtype=torch.float32)
    assert type(t) is tracker.OnlineTracker
    base = ["mixformer_convmae", "baseline", "--dataset_name", "synthetic_rgbt_hard",
            "--device", "cpu", "--dtype", "float32", "--chunk", "4"]
    one = run.main(base + ["--results_dir", str(tmp_path / "one")])[0]
    lock = run.main(base + ["--results_dir", str(tmp_path / "lock"),
                            "--batch_sequences", "3"])[0]
    for k in range(3):
        name = f"synthetic_hard_{k:02d}"
        a, b = (np.loadtxt(os.path.join(d, f"{name}.txt")) for d in (one, lock))
        assert a.shape == (8, 4) and np.abs(a - b).max() <= 1


def test_trainer_accumulates(tmp_path, monkeypatch):
    """Trainer on mixformer_convmae's baseline_large recipe (ACCUM_ITER 3)
    at the tiny geometry, f32: three micro-batches of 2 make one update."""
    from multi_modal_tracking_torch.train.trainer import Trainer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = _cfg(get_default_config, "mixformer_convmae", "baseline_large")
    cfg.DATA.TRAIN.DATASETS_NAME, cfg.DATA.TRAIN.DATASETS_RATIO = ["SyntheticVideo"], [1]
    cfg.DATA.VAL.DATASETS_NAME = []
    cfg.DATA.SEARCH.SIZE, cfg.DATA.TEMPLATE.SIZE = S_SZ, T_SZ
    cfg.DATA.TRAIN.SAMPLE_PER_EPOCH, cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.NUM_WORKER = 6, 2, 0
    cfg.MODEL.BACKBONE.PRETRAINED = False
    tr = Trainer("mixformer_convmae", cfg, save_dir=str(tmp_path), device="cpu", seed=0,
                 dtype=torch.float32, spec_overrides=TINY)
    assert tr.optimizer.accum == 3
    tr.train(max_epochs=1)
    assert len(tr.history) == 3 and all(np.isfinite(h["Loss/total"]) for h in tr.history)
    assert tr.optimizer.count == 1 and tr.optimizer.mini_step == 0
