"""The port's MixFormer-CvT (models/cvt.py) and its trackers, training step,
parameter groups, recipes and checkpoints against the JAX package's, at a
tiny geometry: widths 16 / 32 / 64, heads 1 / 2 / 4, depths 1 / 1 / 2,
template 32, search 64 (strided template keys 16, 4 and 1 per stage), the
CORNER head of 64 channels, the SPM score branch.

The JAX model's randomised variables cross to the port through
`from_jax_variables` (strict). Inputs come from numpy seeds; torch runs on
one intra-op thread, JAX at "highest" matmul precision. The tolerances are
those of tests/test_torch_port_unimodal.py and
tests/test_torch_port_unimodal_train.py, where they are argued:
  * boxes and score logits against JAX: 1e-4; the cached path against the
    port's own full forward, and N streams against N single calls: 1e-5;
  * trackers against their JAX twins: 0.02 px, scores 1e-4, the ring's
    counters equal; a lockstep twin against one stream: 0.05 px;
  * one training step: the metrics 1e-5 relative, grad_norm 1e-3 (box
    step) or 5e-5 (stage 2), the clipped gradients and the updated
    parameters at that file's bounds.
"""
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_modal_tracking_tpu.config import get_default_config as jax_default_config
from multi_modal_tracking_tpu.eval import evaltracker as jax_evaltracker
from multi_modal_tracking_tpu.eval import params as jax_params
from multi_modal_tracking_tpu.models import cvt as jax_cvt
from multi_modal_tracking_tpu.tracking import tracker as jax_tracker
from multi_modal_tracking_tpu.train import optimizer as jax_opt
from multi_modal_tracking_tpu.train.losses import box_losses as jax_box_losses
from multi_modal_tracking_tpu.train.losses import score_loss as jax_score_loss
from multi_modal_tracking_tpu.utils.torch_convert import map_torch_key

from multi_modal_tracking_torch.config import get_default_config
from multi_modal_tracking_torch.eval import datasets, evaltracker, run
from multi_modal_tracking_torch.eval.params import get_parameters, update_interval_for
from multi_modal_tracking_torch.eval.running import run_sequence
from multi_modal_tracking_torch.models import cvt as port_cvt
from multi_modal_tracking_torch.models.build import build_model
from multi_modal_tracking_torch.tracking import batched, tracker
from multi_modal_tracking_torch.train import optimizer as port_opt
from multi_modal_tracking_torch.train import train_step as port_ts
from multi_modal_tracking_torch.utils.checkpoint import load_variables
from multi_modal_tracking_torch.utils.convert import _port_leaves, from_jax_variables

from tests.test_torch_port_model import _randomise
from tests.test_torch_port_unimodal import KW, S_SZ, T_SZ, _frames, _sequences, _with_bias
from tests.test_torch_port_unimodal_train import (_assert_clipped_grads_close, _batch,
                                                  argparse_namespace)
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
TINY = dict(search_size=S_SZ, template_size=T_SZ, dim_embed=(16, 32, 64), num_heads=(1, 2, 4),
            depth=(1, 1, 2), head_dim=64, drop_path_rate=(0.0, 0.0, 0.0))
N_FRAMES = 13                     # frame 0 initialises, 12 are tracked
RECIPES = {"mixformer_cvt": ("baseline", "baseline_1k", "baseline_got", "baseline_large"),
           "mixformer_cvt_online": ("baseline", "baseline_1k", "baseline_got", "baseline_large")}


@pytest.fixture(scope="module", autouse=True)
def _jax_highest():
    """f32 matmuls in JAX."""
    with jax.default_matmul_precision("highest"):
        yield


def _cfg(get, script, recipe="baseline"):
    c = get(script)
    c.update_from_file(os.path.join(ROOT, "experiments", script, f"{recipe}.yaml"))
    return c


def jax_variables(jm, seed, score=True, t_sz=T_SZ, s_sz=S_SZ):
    """Randomised variables of a JAX model without compiling its init:
    jax.eval_shape's tree filled with flax's constant inits (ones for
    norm scales and BN variances, zeros elsewhere), then `_randomise`."""
    t, s = jnp.zeros((1, t_sz, t_sz, 3)), jnp.zeros((1, s_sz, s_sz, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), t, t, s,
                                            run_score_head=score))

    def fill(path, x):
        one = str(getattr(path[-1], "key", path[-1])) in ("scale", "var")
        return np.full(x.shape, 1.0 if one else 0.0, np.float32)
    return _randomise(jax.tree_util.tree_map_with_path(fill, shapes), seed)


def _port(variables, score=True, **spec):
    pm = port_cvt.MixFormerCvT(port_cvt.CvTSpec(**dict(TINY, **spec)), with_score=score).eval()
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return pm


@pytest.fixture(scope="module")
def pair():
    """(JAX MixFormerCvT with the score branch, its variables with the
    score bias centred on the tracking sequence, the port model on them)."""
    jm = jax_cvt.MixFormerCvT(spec=jax_cvt.CvTSpec(**TINY), with_score=True)
    variables = jax_variables(jm, 3)
    pm = _port(variables)
    fv, _, box, _ = _frames(0)
    probe = tracker.OnlineTracker(pm, update_interval=4, online_size=3, device="cpu", **KW)
    probe.initialize(fv[0], {"init_bbox": box})
    s = np.array([probe.track(fv[k])["pred_score"] for k in range(1, N_FRAMES)])
    bias = float(variables["params"]["score_branch"]["score_head"]["layers_2"]["bias"][0])
    variables = _with_bias(variables, bias - float(np.median(np.log(s / (1 - s)))))
    pm.load_state_dict(from_jax_variables(variables))
    return jm, variables, pm


def _images(seed, b=1, n_ot=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, T_SZ, T_SZ, 3)).astype(np.float32),
            rng.standard_normal((b * n_ot, T_SZ, T_SZ, 3)).astype(np.float32),
            rng.standard_normal((b, S_SZ, S_SZ, 3)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _close(got: dict, want: dict, atol=ATOL):
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=atol, rtol=0,
                                   err_msg=k)


# ------------------------------------------------------------------ model
_CACHED = []


def jax_cached(jm):
    """set_online then forward_test of the JAX model, one jitted program
    (one per model): (variables, template, ring, slot mask, search) ->
    (cache, outputs)."""
    for model, fn in _CACHED:
        if model is jm:
            return fn

    def cached(v, t, ot, mask, s):
        cache = jm.apply(v, t, ot, mask, method="set_online")
        return cache, jm.apply(v, s, cache, run_score_head=True, method="forward_test")
    _CACHED.append((jm, jax.jit(cached)))
    return _CACHED[-1][1]


@pytest.mark.parametrize("case", ["full", "cached", "cached_slot_mask", "batched_streams"])
def test_model_matches_jax(pair, case):
    """The full forward (batch 2) against JAX; set_online / forward_test
    with no slot mask (the cached tracker's ring of one) against the port's
    full forward (1e-5); a ring of 3 with 2 live slots (the online tracker)
    against JAX (outputs and every cached k and v) and, the masked slot
    invisible, against a ring of the 2 live slots (1e-5); N = 3 streams at
    once with (N, 3) slot masks, one ring short, against three
    single-stream calls (1e-5) and JAX's."""
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
            mem = [x for stage in cache["mem"] for kv in stage for x in kv]
            assert len(mem) == len(jax.tree_util.tree_leaves(cache_j["mem"])) == 2 * 4
            for a, b in zip(jax.tree_util.tree_leaves(cache_j["mem"]), mem):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)
            live = pm.forward_test(torch.from_numpy(s), pm.set_online(
                *_t(t, ot[:2]), torch.ones(2)), run_score_head=True)
            _close({k: v.numpy() for k, v in got.items()},
                   {k: v.numpy() for k, v in live.items()}, 1e-5)
        else:
            t, ot, s = _images(4, b=3, n_ot=3)
            masks = np.array([[1.0, 1.0, 1.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0]], np.float32)
            cache = pm.set_online(*_t(t, ot), torch.from_numpy(masks))
            assert tuple(cache["slot_mask"].shape) == (3, 3)
            got = pm.forward_test(torch.from_numpy(s), cache, run_score_head=True)
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
#: (JAX class, port class, extra settings); update interval 4: commits at
#: frames 4, 8 and 12, the ring growing 1 -> 2 -> 3, then replacing
TRACKERS = {"cached": (jax_tracker.RGBCachedTrackerJit, tracker.RGBCachedTracker, {}),
            "online": (jax_tracker.OnlineTrackerJit, tracker.OnlineTracker,
                       dict(online_size=3, max_score_decay=0.9))}


@pytest.mark.parametrize("which,mode", [("online", "RGB")])
def test_tracker_matches_jax(pair, which, mode):
    """The online tracker against its JAX twin (the cached one is
    tests/test_torch_port_convmae.py's: a JAX tracker compiles for
    seconds)."""
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
        assert (scores > 0.5).any() and (scores < 0.5).any(), scores
        assert (int(pt._n_filled), int(pt._forget_id)) == \
            (int(jt._state.n_filled), int(jt._state.forget_id)) == (3, 1)
    assert not np.allclose(got[-1]["target_bbox"], got[0]["target_bbox"])


@pytest.mark.parametrize("twin,single,mode", [
    (batched.BatchedRGBCachedTracker, tracker.RGBCachedTracker, "RGB"),
    (batched.BatchedOnlineTracker, tracker.OnlineTracker, "Prompt"),
])
def test_lockstep_twin_matches_one_stream(pair, tmp_path, twin, single, mode):
    """Each lockstep twin at N = 3 (streams of 10, 8 and 7 frames; a
    finished stream's per-stage strided keys frozen) against run_sequence
    of each stream alone: boxes, scores and score files."""
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
            assert (tmp_path / "one" / f"{a['seq']}_score.txt").read_bytes() == \
                (tmp_path / "lock" / f"{a['seq']}_score.txt").read_bytes()


# ------------------------------------------------------------------- train
def _jax_step(jm, variables, batch, cfg):
    """JAX's side of one training step as one compiled program: the loss of
    make_train_step (the box losses in training mode, or stage 2's score
    loss on the net in eval mode), its gradients by jax.grad and the JAX
    package's optimizer (clip, regime groups, AdamW) applied to them.
    Returns (metrics with grad_norm, the clipped gradients and the updated
    parameters and BN statistics under the port's names)."""
    score = bool(cfg.TRAIN.get("TRAIN_SCORE", False))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = jax_opt.make_optimizer(cfg, variables["params"], steps_per_epoch=10)

    def loss_fn(params):
        out, new = jm.apply(dict(variables, params=params), b["template"], b["online_template"],
                            b["search"], run_score_head=score, gt_bboxes=b.get("gt_xyxy"),
                            deterministic=score, train=not score, mutable=["batch_stats"])
        if score:
            loss, metrics = jax_score_loss(out["pred_scores"], b["labels"],
                                           cfg.TRAIN.get("SCORE_WEIGHT", 1.0))
        else:
            loss, metrics = jax_box_losses(out["pred_boxes"], b["gt_xywh"],
                                           cfg.TRAIN.IOU_WEIGHT, cfg.TRAIN.L1_WEIGHT)
        return loss, (metrics, new["batch_stats"])

    def step(params):
        (_, (metrics, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        clipped, _ = optax.clip_by_global_norm(cfg.TRAIN.GRAD_CLIP_NORM).update(grads, None)
        return (dict(metrics, grad_norm=optax.global_norm(grads)), clipped,
                optax.apply_updates(params, updates), stats)

    metrics, clipped, params, stats = jax.device_get(jax.jit(step)(variables["params"]))
    return ({k: float(v) for k, v in metrics.items()}, from_jax_variables({"params": clipped}),
            from_jax_variables({"params": params,
                                "batch_stats": variables["batch_stats"] if score else stats}))


def step_matches_jax(jm, variables, pm, script, recipe="baseline", seed=7):
    """One f32 step of a recipe's regime against the JAX package's from the
    same weights on the same batch (`_jax_step`): the metrics, the clipped
    gradients leaf by leaf and the parameters after the update
    (tests/test_torch_port_unimodal_train.py's bounds), the frozen
    parameters and stage 2's BN statistics unchanged, the box step's BN
    statistics 1e-5. The batch (seed `seed`) must take the clip. Returns
    the port's optimizer."""
    jcfg, pcfg = _cfg(jax_default_config, script, recipe), _cfg(get_default_config, script, recipe)
    score = bool(pcfg.TRAIN.get("TRAIN_SCORE", False))
    batch = _batch(seed, score)
    want, want_grads, want_sd = _jax_step(jm, variables, batch, jcfg)
    before = copy.deepcopy(pm.state_dict())
    opt = port_opt.make_optimizer(pcfg, pm, steps_per_epoch=10)
    got = port_ts.make_train_step(pm, opt, device="cpu", train_score=score,
                                  score_weight=pcfg.TRAIN.get("SCORE_WEIGHT", 1.0))(batch)
    got = {k: float(v) for k, v in got.items()}
    assert got.keys() == want.keys()
    for k in got:
        if k != "grad_norm":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-6, err_msg=k)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=5e-5 if score else 1e-3)
    named = dict(pm.named_parameters())
    grads = dict(zip(named, opt.grads))            # clipped in place before the update
    clip = pcfg.TRAIN.GRAD_CLIP_NORM
    assert got["grad_norm"] > clip
    _assert_clipped_grads_close(grads, want_grads, clip)
    mult = {id(p): opt.mults[g] for g, ps in opt.groups.items() for p in ps}
    for name, v in pm.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name not in named or id(named[name]) not in mult:
            if name in named or score:             # frozen, and stage 2's BN statistics
                assert torch.equal(v, before[name]), name
            else:                                  # the box step's BN statistics
                np.testing.assert_allclose(v.double().numpy(), want_sd[name].double().numpy(),
                                           atol=1e-5, rtol=1e-5, err_msg=name)
            continue
        g, w = v.numpy(), want_sd[name].numpy()
        big = np.abs(grads[name].numpy()) >= 1e-6
        np.testing.assert_allclose(g[big], w[big], atol=1e-6, rtol=1e-6, err_msg=name)
        assert np.abs(g - w).max() <= 2 * pcfg.TRAIN.LR * mult[id(named[name])], name
        assert not big.any() or not np.array_equal(g[big], before[name].numpy()[big]), name
    return opt


def test_train_step_matches_jax(pair):
    """The box step of mixformer_cvt's baseline on a copy of the module's
    model (its score branch takes no gradient and is frozen): trainable
    head BN, the backbone in `main` at 1.0 as JAX labels it (stage 2's
    step is tests/test_torch_port_convmae.py's)."""
    jm, variables, pm = pair
    opt = step_matches_jax(jm, variables, copy.deepcopy(pm), "mixformer_cvt")
    assert set(opt.groups) == {"main"} and opt.mults["main"] == 1.0


def test_trainable_bn_two_steps_match_jax():
    """CvT with BACKBONE.FREEZE_BN false: two f32 box steps of
    mixformer_cvt's baseline against the JAX package's (flax
    `nn.BatchNorm` in every projection, its statistics carried from step
    to step as `mutable=["batch_stats"]` carries them), at template 64,
    search 96 and batch 4. (At template 32 and batch 2 the last stage's
    strided template maps are 1 x 1, so a projection BN's batch holds two
    values per channel: its variance is near 0 and amplifies the two
    sides' rounding into 1e-3 gradient differences.) Each step's metrics
    1e-5 relative; after both, every BN's running mean and variance 1e-5
    (the projection BNs' updates see each crop's own biased batch
    statistics, t, ot then s); the parameters: all within 4 x lr (two AdamW
    steps of at most lr each, which may differ in sign on gradients at
    rounding level) and 99.9% of their elements within lr / 100 (99.98%
    are, as with frozen projection BNs)."""
    t_sz, s_sz, batch = 64, 96, 4
    spec = dict(TINY, freeze_bn=False, template_size=t_sz, search_size=s_sz)
    jm = jax_cvt.MixFormerCvT(spec=jax_cvt.CvTSpec(**spec), with_score=False)
    variables = jax_variables(jm, 5, score=False, t_sz=t_sz, s_sz=s_sz)
    assert any(k.endswith("/bn/scale") for k in _flat_keys(variables["params"]))
    pm = _port(variables, score=False, freeze_bn=False, template_size=t_sz, search_size=s_sz)
    jcfg, pcfg = (_cfg(get, "mixformer_cvt") for get in (jax_default_config, get_default_config))
    batches = []
    for seed in (7, 8):
        rng = np.random.default_rng(seed)
        b = {k: rng.standard_normal((batch, t_sz, t_sz, 3)).astype(np.float32)
             for k in ("template", "online_template")}
        b["search"] = rng.standard_normal((batch, s_sz, s_sz, 3)).astype(np.float32)
        xy, wh = rng.uniform(0.2, 0.5, (batch, 2)), rng.uniform(0.15, 0.35, (batch, 2))
        b["gt_xywh"] = np.concatenate([xy, wh], 1).astype(np.float32)
        batches.append(b)
    tx = jax_opt.make_optimizer(jcfg, variables["params"], steps_per_epoch=10)

    def loss_fn(params, stats, b):
        out, new = jm.apply({"params": params, "batch_stats": stats}, b["template"],
                            b["online_template"], b["search"], train=True, deterministic=False,
                            mutable=["batch_stats"])
        loss, metrics = jax_box_losses(out["pred_boxes"], b["gt_xywh"], jcfg.TRAIN.IOU_WEIGHT,
                                       jcfg.TRAIN.L1_WEIGHT)
        return loss, (metrics, new["batch_stats"])

    def one_step(carry, b):
        params, stats, opt_state = carry
        (_, (metrics, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats, b)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), stats, opt_state), metrics

    def two_steps(params, stats, bs):           # one trace of the step, scanned
        (params, stats, _), metrics = jax.lax.scan(one_step, (params, stats, tx.init(params)),
                                                   bs)
        return metrics, params, stats

    jb = {k: jnp.stack([b[k] for b in batches]) for k in batches[0]}
    metrics, params, stats = jax.device_get(jax.jit(two_steps)(
        variables["params"], variables["batch_stats"], jb))
    want = [{k: v[i] for k, v in metrics.items()} for i in range(2)]
    want_sd = from_jax_variables({"params": params, "batch_stats": stats})
    before = from_jax_variables(variables)

    opt = port_opt.make_optimizer(pcfg, pm, steps_per_epoch=10)
    step = port_ts.make_train_step(pm, opt, device="cpu")
    for b, w in zip(batches, want):
        got = {k: float(v) for k, v in step(b).items()}
        for k in w:
            np.testing.assert_allclose(got[k], float(w[k]), rtol=1e-5, atol=2e-6, err_msg=k)
    named = dict(pm.named_parameters())
    n_stats = n_far = n_all = 0
    for name, v in pm.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        g, w = v.double().numpy(), want_sd[name].double().numpy()
        if name not in named:
            if ".conv_proj_" in name:
                n_stats += 1
                assert not np.array_equal(w, before[name].numpy()), name
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)
            continue
        d = np.abs(g - w) / pcfg.TRAIN.LR
        assert d.max() <= 4, name
        n_far, n_all = n_far + int((d > 0.01).sum()), n_all + d.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)
    assert n_stats == 2 * 3 * sum(TINY["depth"])          # mean, var x q, k, v per block


def _flat_keys(tree, prefix=""):
    for k, v in tree.items():
        yield from (_flat_keys(v, f"{prefix}/{k}") if isinstance(v, dict) else [f"{prefix}/{k}"])


def _jax_groups(cfg, variables) -> dict:
    """The port's parameter names -> the JAX labeller's group, through the
    converter's correspondence of flax paths and port keys."""
    lab, _ = jax_opt._regime_labeler(cfg)
    return {key: lab("/".join(path)) for coll, path, key, _ in _port_leaves(variables)
            if coll == "params"}


@pytest.mark.parametrize("script,recipe", [("mixformer_cvt", "baseline"),
                                           ("mixformer_cvt", "baseline_large"),
                                           ("mixformer_cvt_online", "baseline")],
                         ids=["default", "freeze_stage0", "train_score"])
def test_param_groups_match_jax(pair, script, recipe):
    """Every parameter's group and multiplier, name by name, against the JAX
    package's `_regime_labeler` on the flax tree: the default regime (CvT's
    stages in `main` at 1.0, not `backbone` at BACKBONE_MULTIPLIER: flax
    holds them at the top level), FREEZE_STAGE0 (CvT-24's recipe: stages 1
    and 2 at 0.1, the head at 1.0, stage 0 frozen) and TRAIN_SCORE."""
    _, variables, pm = pair
    jcfg, pcfg = _cfg(jax_default_config, script, recipe), _cfg(get_default_config, script, recipe)
    want = _jax_groups(jcfg, variables)
    _, jmults = jax_opt._regime_labeler(jcfg)
    opt = port_opt.make_optimizer(pcfg, pm)
    got = {name: "frozen" for name, _ in pm.named_parameters()}
    ids = {id(p): n for n, p in pm.named_parameters()}
    for g, ps in opt.groups.items():
        for p in ps:
            got[ids[id(p)]] = g
    assert got == want
    assert opt.mults == {g: m for g, m in jmults.items() if m >= 0 and g in opt.groups}
    if recipe == "baseline" and script == "mixformer_cvt":
        assert set(want.values()) == {"main", "frozen"} and opt.mults["main"] == 1.0
        assert all(want[n] == "main" for n in want if n.startswith("backbone."))


# ------------------------------------------------------------------ build
def _jax_count(model, cfg):
    ts, ss = cfg.DATA.TEMPLATE.SIZE, cfg.DATA.SEARCH.SIZE
    t = jax.ShapeDtypeStruct((1, ts, ts, 3), jnp.float32)
    s = jax.ShapeDtypeStruct((1, ss, ss, 3), jnp.float32)
    return jax.eval_shape(lambda a, b, c: model.init(jax.random.PRNGKey(0), a, b, c,
                                                     run_score_head=True), t, t, s)


def full_width_matches_jax(pm, shapes, frozen_head_bn):
    """Each tensor of the port model (meta device) against jax.eval_shape of
    the JAX model through the JAX converter's name map, and the totals.
    Returns (the port's parameter count, its parameters' flax paths)."""
    flat = {"/".join((c,) + tuple(str(getattr(k, "key", k)) for k in path)): leaf.size
            for c in shapes
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes[c])[0]}
    seen, paths = set(), {}
    for name, p in list(pm.named_parameters()) + list(pm.named_buffers()):
        if "pos_embed" in name or name.endswith("num_batches_tracked"):
            continue
        cands = map_torch_key(name, frozen_head_bn=frozen_head_bn)
        cands = cands if isinstance(cands, list) else [cands]
        key = next(k for k in ("/".join((c,) + tuple(p_)) for c, p_, _ in cands) if k in flat)
        assert flat[key] == p.numel() and key not in seen, (name, key)
        seen.add(key)
        paths[name] = key.split("/", 1)[1]
    assert seen == set(flat)
    n_port = sum(p.numel() for p in pm.parameters())
    assert n_port == sum(v for k, v in flat.items() if k.startswith("params/"))
    return n_port, paths


@pytest.mark.parametrize("script", list(RECIPES))
def test_every_recipe_builds_on_meta(script):
    """All CvT recipes build at full width on the meta device (no weights
    allocated): CvT-21 (64 / 192 / 384, depths 1 / 4 / 16) and CvT-24 (192
    / 768 / 1024, depths 2 / 2 / 12); one recipe of each backbone (the
    online script's) counts its parameters against jax.eval_shape of the
    JAX model, tensor by tensor, and CvT-24's parameter groups under
    FREEZE_STAGE0 (mixformer_cvt/baseline_large) and TRAIN_SCORE follow
    JAX's labeller name by name."""
    for recipe in RECIPES[script]:
        cfg = _cfg(get_default_config, script, recipe)
        with torch.device("meta"):
            pm = port_cvt.build_mixformer_cvt(cfg, with_score=script.endswith("online"))
        depth = (2, 2, 12) if cfg.MODEL.VIT_TYPE == "cvt_24" else (1, 4, 16)
        assert pm.spec.depth == depth and pm.box_head.feat_sz == 20
        assert [len(s.blocks) for s in pm.backbone.stages()] == list(depth)
        if script.endswith("online") and recipe in ("baseline", "baseline_large"):
            jcfg = _cfg(jax_default_config, script, recipe)
            shapes = _jax_count(jax_cvt.build_mixformer_cvt(jcfg, with_score=True), jcfg)
            n, paths = full_width_matches_jax(pm, shapes, cfg.MODEL.get("HEAD_FREEZE_BN", False))
            assert n > 20e6
            if recipe == "baseline_large":
                # CvT-24's groups under its FREEZE_STAGE0 recipe and stage 2's
                # TRAIN_SCORE, name by name against JAX's labeller
                for regime in ("mixformer_cvt", script):
                    lab, _ = jax_opt._regime_labeler(_cfg(jax_default_config, regime, recipe))
                    opt = port_opt.make_optimizer(_cfg(get_default_config, regime, recipe), pm)
                    got = {id(p): g for g, ps in opt.groups.items() for p in ps}
                    for name, p in pm.named_parameters():
                        assert got.get(id(p), "frozen") == lab(paths[name]), (regime, name)


def test_build_model_is_seeded():
    """build_model's init_random covers every parameter and buffer from the
    seed: one seed twice gives the same bits, another seed other values in
    every weight matrix and kernel; frozen BNs keep their identity
    statistics."""
    cfg = get_default_config("mixformer_cvt_online")
    a, b, c = (build_model("mixformer_cvt_online", cfg, device="cpu", seed=seed, spec_overrides=TINY)
               for seed in (3, 3, 4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(not torch.equal(p, sc[k]) for k, p in a.named_parameters() if p.dim() > 1)
    for name, m in a.named_modules():
        if type(m).__name__ == "FrozenBatchNorm2d":
            assert torch.equal(m.running_var, torch.ones_like(m.running_var)), name
    # FREEZE_BN false (no recipe sets it): trainable projection BNs, at
    # flax's init, next to the frozen head-less ones of the recipes
    m = port_cvt.MixFormerCvT(port_cvt.CvTSpec(**dict(TINY, freeze_bn=False)))
    bns = [mod.bn for name, mod in m.named_modules() if name.endswith(("conv_proj_q",
                                                                        "conv_proj_k",
                                                                        "conv_proj_v"))]
    assert bns and all(type(bn).__name__ == "BatchNorm2d" and bn.weight.requires_grad
                       for bn in bns)


@pytest.mark.parametrize("script", ["mixformer_cvt", "mixformer_cvt_online", "mixformer_convmae",
                                    "mixformer_convmae_online"])
def test_parameters_match_jax(script):
    """Every recipe's tracking parameters of the four scripts equal the JAX
    package's (eval/params.py: the script's own tree, no tracking overlay,
    CvT's search factor 5.0 at 320), with the update interval and online
    size of each dataset."""
    recipes = sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "experiments", script)))
    assert len(recipes) == (4 if "cvt" in script else 3)
    for recipe in recipes:
        want = jax_params.get_parameters(script, recipe)
        got = get_parameters(script, recipe)
        assert got.cfg.to_dict() == want.cfg.to_dict(), recipe
        for name in ("template_factor", "template_size", "search_factor", "search_size"):
            assert got.get(name) == want.get(name), (recipe, name)
        for ds in ("", "LasOT", "got10k_test", "trackingnet", "VOT20", "synthetic_rgbt_hard"):
            assert update_interval_for(got.cfg, ds) == jax_params.update_interval_for(want.cfg, ds)
            assert evaltracker.online_size_decay(got.cfg, ds) == \
                jax_evaltracker.online_size_decay(want.cfg, ds), (recipe, ds)
    if "cvt" in script:
        assert got.search_factor == 5.0 and got.search_size == 320


# ------------------------------------------------------------- checkpoints
def test_checkpoints_load(pair, tmp_path):
    """A reference-format `.pth.tar` (`net`, DDP's prefix, a pickled settings
    object) loads strictly, the same bits; a bare ImageNet CvT dict
    (`stage0.*` ..., with the classifier's cls_token, norm and head) gets
    the `backbone.` prefix and loads non-strictly: the stages' tensors
    taken, the extras unused."""
    _, variables, pm = pair
    want = from_jax_variables(variables)
    path = str(tmp_path / "MixFormerOnlineScore_ep0040.pth.tar")
    torch.save({"net": {f"module.{k}": v for k, v in want.items()},
                "settings": argparse_namespace(), "epoch": 40}, path)
    fresh = port_cvt.MixFormerCvT(port_cvt.CvTSpec(**TINY), with_score=True)
    report = load_variables(path, fresh, strict=True)
    got = fresh.state_dict()
    assert report["loaded"] == len(got) and all(torch.equal(got[k], want[k]) for k in want)
    bare = {k[len("backbone."):]: v + 1 for k, v in want.items() if k.startswith("backbone.")}
    extras = {"stage2.cls_token": torch.zeros(1, 1, 64), "norm.weight": torch.ones(64),
              "head.weight": torch.zeros(10, 64)}
    path = str(tmp_path / "CvT-21-384x384-IN-22k.pth")
    torch.save(dict(bare, **extras), path)
    report = load_variables(path, fresh, strict=True)
    got = fresh.state_dict()
    assert report["loaded"] == len(bare) and sorted(report["unexpected"]) == \
        sorted("backbone." + k for k in extras)
    assert all(torch.equal(got["backbone." + k], v) for k, v in bare.items())
    assert torch.equal(got["box_head.conv5_tl.weight"], want["box_head.conv5_tl.weight"])


# ------------------------------------------------------------ entry points
@pytest.fixture
def tiny_cli(monkeypatch):
    """create_tracker's models at the tiny geometry, the datasets cut to 3
    sequences of 8 frames."""
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
    """create_tracker picks as the JAX package does (search factor 5.0 at
    320, no tracking overlay; OnlineTracker with the dataset's online size
    for the online script, RGBCachedTracker for the base one); `eval.run
    mixformer_cvt_online baseline --type TIR` one stream and
    --batch_sequences 3 write result and score files within a pixel of
    each other (the files hold integers)."""
    params = get_parameters("mixformer_cvt_online", "baseline")
    assert params.search_factor == 5.0 and params.search_size == 320
    t = evaltracker.create_tracker(params, "got10k_test", device="cpu", dtype=torch.float32)
    assert type(t) is tracker.OnlineTracker and t.online_size == 2 and t.update_interval == 10
    assert type(run._batched_twin(t, 4)) is batched.BatchedOnlineTracker
    t = evaltracker.create_tracker(get_parameters("mixformer_cvt", "baseline"), "lasot",
                                   device="cpu", dtype=torch.float32)
    assert type(t) is tracker.RGBCachedTracker and t.mode == "RGB"
    base = ["mixformer_cvt_online", "baseline", "--dataset_name", "synthetic_rgbt_hard",
            "--type", "TIR", "--device", "cpu", "--dtype", "float32", "--chunk", "4"]
    one = run.main(base + ["--results_dir", str(tmp_path / "one")])[0]
    lock = run.main(base + ["--results_dir", str(tmp_path / "lock"),
                            "--batch_sequences", "3"])[0]
    for k in range(3):
        name = f"synthetic_hard_{k:02d}"
        a, b = (np.loadtxt(os.path.join(d, f"{name}.txt")) for d in (one, lock))
        assert a.shape == (8, 4) and np.abs(a - b).max() <= 1
        assert np.loadtxt(os.path.join(lock, f"{name}_score.txt")).shape == (8,)


def test_trainer_runs_an_epoch(tmp_path, monkeypatch):
    """Trainer on mixformer_cvt's baseline at the tiny geometry (f32,
    SyntheticVideo, two steps of batch 2): finite losses, the backbone in
    `main`, a checkpoint that a fresh Trainer resumes from."""
    from multi_modal_tracking_torch.train.trainer import Trainer
    # the metrics log without TensorBoard's ~10 s import (JSONL only)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = _cfg(get_default_config, "mixformer_cvt")
    cfg.DATA.TRAIN.DATASETS_NAME, cfg.DATA.TRAIN.DATASETS_RATIO = ["SyntheticVideo"], [1]
    cfg.DATA.VAL.DATASETS_NAME = []
    cfg.DATA.SEARCH.SIZE, cfg.DATA.TEMPLATE.SIZE = S_SZ, T_SZ
    cfg.DATA.TRAIN.SAMPLE_PER_EPOCH, cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.NUM_WORKER = 4, 2, 0
    cfg.MODEL.BACKBONE.PRETRAINED = False
    kw = dict(save_dir=str(tmp_path), device="cpu", seed=0, dtype=torch.float32,
              spec_overrides=TINY)
    tr = Trainer("mixformer_cvt", cfg, **kw)
    tr.train(max_epochs=1)
    assert len(tr.history) == 2 and all(np.isfinite(h["Loss/total"]) for h in tr.history)
    assert set(tr.optimizer.groups) == {"main"}
    again = Trainer("mixformer_cvt", cfg, **kw)
    assert again.load_checkpoint() and again.epoch == 1
    assert all(torch.equal(a, b) for a, b in zip(again.model.state_dict().values(),
                                                 tr.model.state_dict().values()))
