"""The port's RGB-T MixFormer-ViT family (models/vit.py, models/vit_rgbt.py)
against the JAX package's, at a tiny geometry: depth 2, embed 64, 4 heads
(D 16), template 32, search 64 (8 + 8 + 16 tokens), head channel 64,
fusion d_model 512 with 2 layers; batch 2 (stacks of 4).

The port's weights (`init_random`, perturbed from a numpy seed) cross to
the JAX models through the JAX package's converter with strict=True. Inputs
come from numpy seeds; torch runs on one intra-op thread, JAX at "highest"
matmul precision.

Tolerances, f32 on both sides:
  * the backbone's feature maps and the models' boxes and score logits:
    1e-4 abs (measured differences ~1e-6; a wrong mask, split or key
    gives >= 1e-3);
  * the trackers create_tracker gives (full forward every frame) against
    JAX's RGBTTrackerJit: 0.02 px over 8 frames (the tolerance of the JAX
    loop against its torch oracle, tests/test_tracking_loop_parity.py);
  * lockstep N = 2 against one stream each: 0.05 px (other GEMM shapes);
  * the training step: tests/test_torch_port_train_step.py's bounds.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.config import get_default_config as jax_default_config
from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as
from multi_modal_tracking_tpu.models import vit as jax_vit
from multi_modal_tracking_tpu.models import vit_rgbt as jax_vr
from multi_modal_tracking_tpu.ops import attention as jax_attention
from multi_modal_tracking_tpu.tracking import tracker as jax_tracker
from multi_modal_tracking_tpu.train import optimizer as jax_opt
from multi_modal_tracking_tpu.train.losses import box_losses as jax_box_losses
from multi_modal_tracking_tpu.utils.torch_convert import convert_state_dict, map_torch_key

from multi_modal_tracking_torch.config import get_default_config
from multi_modal_tracking_torch.eval import evaltracker, run as eval_run
from multi_modal_tracking_torch.eval.params import get_parameters
from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.models import vit as port_vit
from multi_modal_tracking_torch.models import vit_rgbt as port_vr
from multi_modal_tracking_torch.models.build import build_model, init_random
from multi_modal_tracking_torch.tracking import batched as port_batched
from multi_modal_tracking_torch.tracking import tracker as port_tracker
from multi_modal_tracking_torch.train import optimizer as port_opt
from multi_modal_tracking_torch.train import train_step as port_ts
from multi_modal_tracking_torch.train.losses import box_losses
from multi_modal_tracking_torch.utils.checkpoint import load_variables
from multi_modal_tracking_torch.utils.convert import from_jax_variables
from tests.test_torch_port_fusion_zoo import randomise_port
from tests.test_torch_port_train_step import assert_grads_close
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_SZ, S_SZ = 32, 64
ATOL = 1e-4
TINY = dict(search_size=S_SZ, template_size=T_SZ, embed_dim=64, depth=2, num_heads=4,
            head_dim=64, fusion_layers=2)
#: script -> (variant, score branch, recipe, the recipe's FUSION_CLASS and HEAD_TYPE)
SCRIPTS = {
    "mixformer_vit_rgbt": ("two_stream", False, "attention_lasher_newfusion_2layer",
                           "Attention_Fusion_Bimodal_LNSpecific", "CORNER_UP"),
    "mixformer_vit_rgbt_online": ("two_stream", True, "attention_lasher_newfusion_2layer",
                                  "Attention_Fusion_Bimodal_LNSpecific", "CORNER_UP"),
    "mixformer_vit_rgbt_shared": ("shared", False, "baseline_attention_lasher_newfusion_2layer",
                                  "Attention_Fusion_Bimodal", "CORNER_UP"),
    "mixformer_vit_rgbt_unibackbone": ("unibackbone", False, "baseline",
                                       "Attention_Fusion_Bimodal_LNSpecific_2", "CORNER"),
}
H, W = 240, 320
N_FRAMES = 9                      # frame 0 initialises, 8 are tracked
KW = dict(template_factor=2.0, template_size=T_SZ, search_factor=4.5, search_size=S_SZ,
          update_interval=3)


@pytest.fixture(scope="module", autouse=True)
def _jax_highest():
    """f32 matmuls in JAX."""
    with jax.default_matmul_precision("highest"):
        yield


def _geom(script, **kw):
    _, _, _, fusion, head = SCRIPTS[script]
    return dict(TINY, fusion_class=fusion, head_type=head, **kw)


def to_jax(port_sd, jax_vars):
    sd = {k: v.numpy() for k, v in port_sd.items()}
    out, report = convert_state_dict(sd, dict(jax_vars), strict=True, verbose=False)
    assert not report["skipped"] and not report["missing"]
    return out


def _stacks(seed, B=2):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((2 * B, T_SZ, T_SZ, 3)).astype(np.float32)
    ot = rng.standard_normal((2 * B, T_SZ, T_SZ, 3)).astype(np.float32)
    s = rng.standard_normal((2 * B, S_SZ, S_SZ, 3)).astype(np.float32)
    return t, ot, s


def _jax_model(script, **geom_kw):
    variant, with_score = SCRIPTS[script][:2]
    jm = jax_vr.MixFormerViTRGBT(spec=jax_vr.VitRGBTSpec(
        base=jax_as.RGBTSpec(**_geom(script, **geom_kw)), variant=variant),
        with_score=with_score)
    t, ot, s = _stacks(0)
    jvars = jax.jit(lambda k: jm.init(k, t, ot, s, run_score_head=True))(jax.random.PRNGKey(0))
    return jm, jvars


def _pair(script, seed, **geom_kw):
    """(JAX model, its variables, the port model in eval mode) on the port's
    perturbed weights."""
    jm, jvars = _jax_model(script, **geom_kw)
    variant, with_score = SCRIPTS[script][:2]
    pm = port_vr.MixFormerViTRGBT(port_as.RGBTSpec(**_geom(script, **geom_kw)), variant,
                                  with_score)
    pm = randomise_port(init_random(pm, seed), seed).eval()
    return jm, to_jax(pm.state_dict(), jvars), pm


@pytest.fixture(scope="module")
def pairs():
    return {script: _pair(script, i) for i, script in enumerate(SCRIPTS)}


# ------------------------------------------------------------------ models
def test_vit_backbone_matches_pallas_interpret(monkeypatch):
    """MixFormerViT alone against the JAX backbone with its Pallas mixed
    attention kernel run in interpret mode (ops.attention.FORCE_INTERPRET,
    as tests/test_pallas_attention.py runs it): the three feature maps."""
    monkeypatch.setattr(jax_attention, "FORCE_INTERPRET", True)
    kw = dict(img_size_s=S_SZ, img_size_t=T_SZ, embed_dim=64, depth=2, num_heads=4)
    jm = jax_vit.MixFormerViT(**kw)
    t, ot, s = _stacks(1, B=1)
    jvars = jax.jit(jm.init)(jax.random.PRNGKey(0), t, ot, s)
    pm = randomise_port(init_random(port_vit.MixFormerViT(**kw), 3), 3).eval()
    sd = {f"backbone.{k}": v for k, v in pm.state_dict().items()}
    jvars = {"params": to_jax(sd, {"params": {"backbone": jvars["params"]}})["params"]["backbone"]}
    want = jax.jit(jm.apply)(jvars, t, ot, s)
    with torch.no_grad():
        got = pm(*(torch.from_numpy(x) for x in (t, ot, s)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("script", SCRIPTS)
def test_model_matches_jax(pairs, script):
    """Each script's boxes, and the online script's score logits, in eval
    mode; and the weights back through from_jax_variables."""
    jm, jvars, pm = pairs[script]
    t, ot, s = _stacks(10)
    want = jax.jit(lambda v, a, b, c: jm.apply(v, a, b, c, run_score_head=True))(
        jvars, t, ot, s)
    with torch.no_grad():
        got = pm(*(torch.from_numpy(x) for x in (t, ot, s)), run_score_head=True)
    assert got.keys() == want.keys() == ({"pred_boxes", "pred_scores"} if pm.with_score
                                         else {"pred_boxes"})
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0,
                                   err_msg=k)
    back = from_jax_variables(jax.device_get(jvars))
    sd = pm.state_dict()
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def test_build_model_builds_the_family():
    """build_model builds the four scripts from their recipes' configs
    (the online one from the two-stream config: it has no default tree,
    in the JAX package neither)."""
    for script, (variant, with_score, recipe, fusion, head) in SCRIPTS.items():
        cfg = get_parameters("mixformer_vit_rgbt" if script.endswith("_online") else script,
                             recipe).cfg
        m = build_model(script, cfg, device="cpu", spec_overrides=TINY)
        assert (m.variant, m.with_score, m.spec.fusion_class, m.spec.head_type) == \
            (variant, with_score, fusion, head)
        assert hasattr(m, "backbone_v") == (variant == "two_stream")
    with pytest.raises(KeyError):
        get_default_config("mixformer_vit_rgbt_online")


# ---------------------------------------------------------------- tracking
def _frames(seed):
    """240x320 textured noise with a bright moving 48x48 square and a
    replicated-gray TIR (tests/test_torch_port_tracker.py's sequence)."""
    rng = np.random.default_rng(seed)
    fv = rng.integers(0, 120, (N_FRAMES, H, W, 3), dtype=np.uint8)
    fi = rng.integers(0, 120, (N_FRAMES, H, W, 3), dtype=np.uint8)
    x0, y0 = 80 + 7 * seed, 60 + 5 * seed
    for t in range(N_FRAMES):
        x, y = x0 + 5 * t, y0 + 3 * t
        fv[t, y:y + 48, x:x + 48] = 230
        fi[t, y:y + 48, x:x + 48] = 200
        fi[t] = fi[t][..., :1].repeat(3, axis=-1)
    return fv, fi, np.array([x0, y0, 48.0, 48.0], np.float32)


def _created(script, monkeypatch, seed):
    """create_tracker(f32, CPU) on the script's recipe at the tiny geometry,
    its weights perturbed; update interval 3."""
    orig = evaltracker.build_model
    monkeypatch.setattr(evaltracker, "build_model", lambda *a, **kw: orig(
        *a, spec_overrides=_geom(script), **kw))
    params = get_parameters(script, SCRIPTS[script][2])
    params.template_size, params.search_size = T_SZ, S_SZ
    tr = evaltracker.create_tracker(params, device="cpu", dtype=torch.float32, seed=seed)
    randomise_port(tr.model, seed)
    tr.update_interval = 3
    return tr


def _track(tracker, fv, fi, box):
    tracker.initialize([fv[0], fi[0]], {"init_bbox": box})
    return np.asarray([tracker.track([fv[t], fi[t]])["target_bbox"]
                       for t in range(1, len(fv))], np.float64)


@pytest.mark.parametrize("script", ["mixformer_vit_rgbt", "mixformer_vit_rgbt_shared"])
def test_created_tracker_matches_jax(script, monkeypatch):
    """The tracker create_tracker gives (full forward: RGBTTracker, no
    template cache) against JAX's RGBTTrackerJit on the same weights, 8
    frames with template updates at frames 3 and 6."""
    pt = _created(script, monkeypatch, 4)
    assert type(pt) is port_tracker.RGBTTracker
    jm, jvars = _jax_model(script)
    jvars = to_jax(pt.model.state_dict(), jvars)
    fv, fi, box = _frames(0)
    jt = jax_tracker.RGBTTrackerJit(model=jm, variables=jvars, **KW)
    jt.initialize([fv[0], fi[0]], {"init_bbox": box})
    want = np.asarray([jt.track([fv[t], fi[t]])["target_bbox"] for t in range(1, N_FRAMES)])
    got = _track(pt, fv, fi, box)
    np.testing.assert_allclose(got, want, atol=0.02, rtol=0)


def test_lockstep_matches_one_stream(pairs):
    """Two different sequences in lockstep (the two-stream model splits the
    stack [RGB x N; TIR x N] by halves) against each tracked alone."""
    _, _, pm = pairs["mixformer_vit_rgbt"]
    seqs = [_frames(0), _frames(1)]
    want = np.stack([_track(port_tracker.RGBTTracker(pm, device="cpu", **KW), *seq)
                     for seq in seqs], axis=1)
    bt = port_batched.BatchedRGBTTracker(pm, device="cpu", **KW)
    fv = np.stack([s[0] for s in seqs], axis=1)
    fi = np.stack([s[1] for s in seqs], axis=1)
    bt.initialize(fv[0], fi[0], np.stack([s[2] for s in seqs]))
    got = bt.track_block(fv[1:], fi[1:], np.ones((N_FRAMES - 1, 2), bool))
    assert got.shape == want.shape == (N_FRAMES - 1, 2, 4)
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0)
    assert np.abs(want[:, 0] - want[:, 1]).max() > 1.0       # the sequences differ


@pytest.mark.parametrize("script,single,twin", [
    ("mixformer_vit_rgbt", port_tracker.RGBTTracker, port_batched.BatchedRGBTTracker),
    ("mixformer_vit_rgbt_online", port_tracker.RGBTOnlineTracker,
     port_batched.BatchedRGBTOnlineTracker),
    ("asymmetric_shared_ce", port_tracker.RGBTCachedTracker,
     port_batched.BatchedRGBTCachedTracker),
])
def test_batched_twin_follows_the_tracker(script, single, twin, monkeypatch):
    """create_tracker picks the full-forward trackers for the ViT family
    (no set_online / forward_track) and the cached ones for the flagship;
    the CLI's lockstep twin follows it."""
    base = "mixformer_vit_rgbt" if script == "mixformer_vit_rgbt_online" else script
    orig = evaltracker.build_model
    overrides = dict(TINY, ce_loc=None) if script.startswith("asym") else \
        _geom(script)
    monkeypatch.setattr(evaltracker, "build_model", lambda *a, **kw: orig(
        *a, spec_overrides=overrides, **kw))
    params = get_parameters(base, "attention_lasher_newfusion_2layer")
    params.script = script
    tr = evaltracker.create_tracker(params, device="cpu", dtype=torch.float32)
    assert type(tr) is single
    bt = eval_run._batched_twin(tr, 4)
    assert type(bt) is twin and bt.model is tr.model and bt.scan_chunk == 4
    assert getattr(bt, "max_score_decay", None) == getattr(tr, "max_score_decay", None)


# ---------------------------------------------------------------- training
B = 2


def _batch(seed):
    t, ot, s = _stacks(seed, B)
    rng = np.random.default_rng(seed + 100)
    xy = rng.uniform(0.2, 0.5, (B, 2))
    wh = rng.uniform(0.15, 0.35, (B, 2))
    return t, ot, s, np.concatenate([xy, wh], 1).astype(np.float32)


def _train_models(which):
    """(JAX model, variables, port model without drop rates) of the
    two-stream script or the asymmetric_shared recipe with RGBT_Fusion_Cat."""
    off = dict(drop_path_rate=0.0, fusion_dropout=0.0)
    if which == "two_stream":
        jm, jvars = _jax_model("mixformer_vit_rgbt")
        pm = port_vr.MixFormerViTRGBT(port_as.RGBTSpec(**_geom("mixformer_vit_rgbt"), **off))
    else:
        geom = dict(TINY, fusion_class="RGBT_Fusion_Cat", head_type="CORNER_UP")
        jm = jax_as.MixFormerRGBT(spec=jax_as.RGBTSpec(**geom))
        t, ot, s = _stacks(0)
        jvars = jax.jit(jm.init)(jax.random.PRNGKey(0), t, ot, s)
        pm = port_as.MixFormerRGBT(port_as.RGBTSpec(**geom, **off))
    pm = randomise_port(init_random(pm, 7), 7)
    return jm, to_jax(pm.state_dict(), jvars), pm


@pytest.mark.parametrize("which", ["two_stream", "fusion_cat"])
def test_train_step_matches_eager_and_jax(which):
    """One CPU training step (TrainStep, f32): its loss and metrics equal
    the eager forward and backward of the same model bit for bit, its grad
    norm theirs; the eager step's loss, metrics, gradients and the conv
    fusion's BatchNorm statistics match jax.grad of the JAX model's loss
    (tests/test_torch_port_train_step.py's bounds)."""
    jm, jvars, pm = _train_models(which)
    batch = _batch(3)
    t, ot, s, gt = (jnp.asarray(x) for x in batch)

    def loss_fn(params, bs):
        out, mutated = jm.apply({"params": params, "batch_stats": bs}, t, ot, s, None,
                                deterministic=True, train=True, mutable=["batch_stats"])
        loss, metrics = jax_box_losses(out["pred_boxes"], gt, 2.0, 5.0)
        return loss, (metrics, mutated["batch_stats"])

    grads, (jmetrics, jstats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        jvars["params"], jvars["batch_stats"])

    eager = copy.deepcopy(pm).train()
    tt, tot, ts, tgt = (torch.from_numpy(x) for x in batch)
    loss, metrics = box_losses(eager(tt, tot, ts)["pred_boxes"], tgt, 2.0, 5.0)
    loss.backward()
    gnorm = torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in eager.parameters()]))
    for k, v in jmetrics.items():
        # IoU of random weights' boxes is ~5e-3 here: 2e-6 abs beside 1e-5 rel
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, atol=2e-6,
                                   err_msg=k)
    jnorm = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree_util.tree_leaves(grads))))
    np.testing.assert_allclose(float(gnorm), jnorm, rtol=1e-3)
    assert_grads_close(eager, from_jax_variables({"params": jax.device_get(grads)}), jnorm)
    buffers = dict(eager.named_buffers())
    for name, w in from_jax_variables({"batch_stats": jax.device_get(jstats)}).items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(buffers[name].numpy(), w.numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=name)

    cfg = get_default_config("mixformer_vit_rgbt" if which == "two_stream"
                             else "asymmetric_shared")
    opt = port_opt.make_optimizer(cfg, pm, steps_per_epoch=1)
    step = port_ts.make_train_step(pm, opt, device="cpu")
    x = {"t": tt, "ot": tot, "s": ts, "gt_xywh": tgt}
    got = step(x)
    for k in ("Loss/total", "Loss/ciou", "Loss/l1", "IoU"):
        assert torch.equal(got[k], metrics[k].detach().float()), k
    torch.testing.assert_close(got["grad_norm"], gnorm, rtol=1e-6, atol=0)
    for name, b in pm.named_buffers():
        assert torch.equal(b, buffers[name]), name


# -------------------------------------------------------------- optimizer
#: (script, recipe) of the regimes tested, with the two kept quirks:
#: unibackbone recipes train in the shared regime (backbone 0.02), and
#: mixformer_vit_rgbt_shared/baseline in the two-stream one (its backbone
#: at multiplier 1.0)
RECIPES = [("mixformer_vit_rgbt", "attention_lasher_newfusion_2layer"),
           ("mixformer_vit_rgbt_shared", "baseline_attention_lasher_newfusion_2layer"),
           ("mixformer_vit_rgbt_shared", "baseline"),
           ("mixformer_vit_rgbt_unibackbone", "baseline"),
           ("mixformer_vit_rgbt_unibackbone", "attention_lasher_newfusion_2layer"),
           ("asymmetric_shared", "attention_lasher_cat_3layer"),
           ("asymmetric_shared", "attention-lasher-cross_deform_fusion_sum_2layer")]


def _cfgs(script, recipe):
    out = []
    for fn in (jax_default_config, get_default_config):
        c = fn(script)
        c.update_from_file(os.path.join(ROOT, "experiments", script, f"{recipe}.yaml"))
        out.append(c)
    return out


@pytest.mark.parametrize("script,recipe", RECIPES)
def test_regime_groups_match_jax(script, recipe):
    """Every parameter's group and multiplier equal the JAX labeler's on its
    flax path (the JAX converter's mapping of the port's reference name)."""
    jcfg, pcfg = _cfgs(script, recipe)
    jlab, jm = jax_opt._regime_labeler(jcfg)
    plab, pm = port_opt._regime_labeler(pcfg)
    assert jm == pm
    model = build_model(script, pcfg, device="cpu",
                        spec_overrides=dict(TINY, head_dim=32, fusion_layers=1))
    groups = {}
    for name, _ in model.named_parameters():
        cands = map_torch_key(name)
        cands = cands if isinstance(cands, list) else [cands]
        path = "/".join(next(p for c, p, _ in cands if c == "params"))
        assert plab(name) == jlab(path), (name, path)
        groups.setdefault(plab(name), []).append(name)
    if script == "mixformer_vit_rgbt_unibackbone":
        assert pm["backbone"] == 0.02 and groups["backbone"]
    if (script, recipe) == ("mixformer_vit_rgbt_shared", "baseline"):
        assert "backbone" not in groups and pm["main"] == 1.0 and \
            any(n.startswith("backbone.") for n in groups["main"])
    if script == "mixformer_vit_rgbt":
        assert pm["backbone_v"] == 0.02 and pm["backbone_i"] == 0.1
    assert any(n.endswith("sampling_offsets.weight") for n in groups.get("fusion_off", [])) \
        or "RGBT_Fusion" in pcfg.MODEL.FUSION_CLASS


# -------------------------------------------------------------- warm start
@pytest.mark.parametrize("variant", ["two_stream", "shared"])
def test_unimodal_warm_start(variant, tmp_path):
    """A unimodal `.pth.tar` (the reference's names: backbone.*, norm1 /
    norm2, tests/test_torch_convert.py's oracle) fills both backbones of
    the two-stream model and both LayerNorms of each pair of the shared-LN
    one; the load is a warm start (non-strict), whatever `strict` says."""
    from tests.test_torch_convert import DIM, HEADS, S_SZ as O_S, T_SZ as O_T, _Oracle
    torch.manual_seed(0)
    sd = {k: v for k, v in _Oracle().state_dict().items()}
    path = str(tmp_path / "unimodal.pth.tar")
    torch.save({"net": sd}, path)
    spec = port_as.RGBTSpec(search_size=O_S, template_size=O_T, embed_dim=DIM, depth=2,
                            num_heads=HEADS, head_dim=DIM, fusion_layers=1)
    model = init_random(port_vr.MixFormerViTRGBT(spec, variant), 1)
    report = load_variables(path, model, strict=True)
    got = model.state_dict()
    bb = {k: v for k, v in sd.items() if k.startswith("backbone.") and
          not k.startswith(("backbone.pe_", "backbone.pos_embed"))}
    assert bb and report["loaded"] > len(bb)
    for k, v in bb.items():
        rest = k[len("backbone."):]
        if variant == "two_stream":
            targets = [f"backbone_v.{rest}", f"backbone_i.{rest}"]
        elif ".norm1." in k or ".norm2." in k:
            n = ".norm1." if ".norm1." in k else ".norm2."
            targets = [k.replace(n, n[:-1] + "_v."), k.replace(n, n[:-1] + "_i.")]
        else:
            targets = [k]
        for t in targets:
            assert torch.equal(got[t], v), t
