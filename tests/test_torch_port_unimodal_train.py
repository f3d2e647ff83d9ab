"""Unimodal training and loading in the port against the JAX package, at the
tiny geometry of tests/test_torch_port_unimodal.py: the loader's batches
(SyntheticVideo + UnimodalProcessing), one box step of `mixformer_vit` and
one stage-2 step of `mixformer_vit_online` against
`make_train_step(rgbt=False)`, checkpoints in the reference's and the JAX
package's formats, every unimodal recipe through `build_model`, and the
ViT-L recipes' parameters against the JAX models' at full width.

Tolerances:
  * batches: the sampled frames the same, boxes within 1e-6, images within
    one grey level (tests/test_torch_port_train_data.py's bounds); the
    port's native and numpy pixels the same bits;
  * the steps: the loss and the metrics 1e-5 relative (2e-6 absolute for
    an IoU near zero), grad_norm 1e-3 relative (box step: ReLU and
    bilinear switches flip on rounding, tests/test_torch_port_train_step.py)
    and 5e-5 (stage 2). The clipped gradients that enter AdamW, the port's
    against JAX's (`jax.grad` of the step's own loss, clipped by optax's
    rule), with Gc the clipped global norm:
      ||g - w|| <= 1e-4 Gc                    (all parameters together)
      ||g - w|| <= 1e-3 ||w|| + 1e-6 Gc       (each tensor, Frobenius)
      |g - w|   <= 1e-2 max|w| + 1e-6 Gc      (every element)
    Measured on these batches: together 2.0e-6 Gc (box step) and 1.1e-6
    (stage 2), each tensor within 3.6e-5 of its norm, each element within
    3.6e-5 of its tensor's largest. The 1e-6 Gc floor covers gradients
    that are exactly zero and come out as rounding noise of order 1e-10:
    the conv biases in front of the head's training-mode BatchNorms and
    the score branch's key-projection biases (softmax ignores a shift of
    every logit). A sign error in a backward, a dropped path or a wrong
    clip gives errors of order ||w||;
  * the parameters after the update 1e-6 (absolute and relative) wherever
    the clipped gradient is at least 1e-6, a hundred times Adam's eps
    (measured: within 3e-9 beyond that). Adam's first step moves a
    parameter by lr g / (|g| + eps), so where g is within a hundred eps
    of zero the two sides' rounding of g decides the step: there they
    agree within 2 lr, the most two first steps can differ. The frozen
    parameters and the BatchNorm statistics of stage 2 the same bits as
    before the step; the box step's statistics 1e-5;
  * checkpoint loads: the same bits.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from multi_modal_tracking_tpu.config import get_default_config as jax_default_config
from multi_modal_tracking_tpu.eval import evaltracker as jax_evaltracker
from multi_modal_tracking_tpu.eval import params as jax_params
from multi_modal_tracking_tpu.models import mixformer as jax_mf
from multi_modal_tracking_tpu.models import vit_rgbt as jax_vr
from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as
from multi_modal_tracking_tpu.train import builders as jax_builders
from multi_modal_tracking_tpu.train import optimizer as jax_opt
from multi_modal_tracking_tpu.train import train_step as jax_ts
from multi_modal_tracking_tpu.train.losses import box_losses as jax_box_losses
from multi_modal_tracking_tpu.train.losses import score_loss as jax_score_loss
from multi_modal_tracking_tpu.utils.torch_convert import map_torch_key

from multi_modal_tracking_torch.config import get_default_config
from multi_modal_tracking_torch.eval import evaltracker
from multi_modal_tracking_torch.eval import params as port_params
from multi_modal_tracking_torch.models import mixformer as port_mf
from multi_modal_tracking_torch.models.build import build_model
from multi_modal_tracking_torch.models.vit_rgbt import build_vit_rgbt
from multi_modal_tracking_torch.train import builders
from multi_modal_tracking_torch.train import optimizer as port_opt
from multi_modal_tracking_torch.train import train_step as port_ts
from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
from multi_modal_tracking_torch.train.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from multi_modal_tracking_torch.utils.checkpoint import load_variables
from multi_modal_tracking_torch.utils.convert import from_jax_variables

from tests.test_torch_port_model import _randomise
from tests.test_torch_port_unimodal import S_SZ, T_SZ, TINY
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2
RECIPES = {"mixformer_vit": ("baseline", "baseline_got", "baseline_large", "baseline_large_tir"),
           "mixformer_vit_online": ("baseline", "baseline_got", "baseline_large",
                                    "baseline_tir")}


def _cfg(get, script, recipe="baseline"):
    c = get(script)
    c.update_from_file(os.path.join(ROOT, "experiments", script, f"{recipe}.yaml"))
    return c


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("script", list(RECIPES))
def test_parameters_match_jax(script):
    """Every recipe's tracking parameters equal JAX's: the default tree and
    the recipe, no tracking overlay (a unimodal script's parameter files
    take none), the update interval and online size of each dataset."""
    for recipe in RECIPES[script]:
        want = jax_params.get_parameters(script, recipe)
        got = port_params.get_parameters(script, recipe)
        assert got.cfg.to_dict() == want.cfg.to_dict(), recipe
        for name in ("template_factor", "template_size", "search_factor", "search_size"):
            assert got.get(name) == want.get(name), (recipe, name)
        for ds in ("", "LasOT", "got10k_test", "trackingnet", "VOT20", "synthetic_rgbt_hard"):
            assert port_params.update_interval_for(got.cfg, ds) == \
                jax_params.update_interval_for(want.cfg, ds), (recipe, ds)
            assert evaltracker.online_size_decay(got.cfg, ds) == \
                jax_evaltracker.online_size_decay(want.cfg, ds), (recipe, ds)


# ------------------------------------------------------------------ loader
def _data_cfg(get):
    c = _cfg(get, "mixformer_vit")
    c.DATA.TRAIN.DATASETS_NAME, c.DATA.TRAIN.DATASETS_RATIO = ["SyntheticVideo"], [1]
    c.DATA.VAL.DATASETS_NAME = []
    c.DATA.TRAIN.SAMPLE_PER_EPOCH = 4
    c.TRAIN.BATCH_SIZE = 2
    c.TRAIN.NUM_WORKER = 0
    return c


def test_loader_batches_match_jax():
    """Two batches of the unimodal loader (seed 5) against the JAX
    package's: native pixels (the Trainer's) and numpy pixels the same
    bits, and both against JAX's cv2 pixels; then the model inputs of a
    batch (rgbt=False)."""
    want = list(jax_builders.build_dataloaders(_data_cfg(jax_default_config), seed=5)[0])
    got = list(builders.build_train_loader(_data_cfg(get_default_config), seed=5))
    loader = builders.build_train_loader(_data_cfg(get_default_config), seed=5)
    assert type(loader.sampler.processing).__name__ == "UnimodalProcessing"
    assert not loader.sampler.rgbt
    loader.sampler.processing.pixels = "plain"
    plain = list(loader)
    assert len(got) == len(want) == len(plain) == 2
    for g, w, p in zip(got, want, plain):
        assert g.keys() == p.keys() and {"template_images", "search_images"} <= set(g)
        for k in g:
            np.testing.assert_array_equal(g[k], p[k], err_msg=k)
        for k in ("template_anno", "search_anno"):
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0, err_msg=k)
        for k in ("template_images", "search_images"):
            assert g[k].shape == w[k].shape and g[k].dtype == np.float32
            pixels = lambda x: x * IMAGENET_STD + IMAGENET_MEAN   # noqa: E731
            np.testing.assert_allclose(pixels(g[k]), pixels(w[k]), atol=1.001 / 255, rtol=0)
    x = port_ts.model_inputs(batch_to_model_inputs(got[0], rgbt=False), "cpu")
    assert tuple(x["t"].shape) == (B, 128, 128, 3) and tuple(x["s"].shape) == (B, 288, 288, 3)
    assert torch.equal(x["ot"], torch.from_numpy(got[0]["template_images"][1]))


# ------------------------------------------------------------------- steps
def _batch(seed, score):
    rng = np.random.default_rng(seed)
    b = {k: rng.standard_normal((B, T_SZ, T_SZ, 3)).astype(np.float32)
         for k in ("template", "online_template")}
    b["search"] = rng.standard_normal((B, S_SZ, S_SZ, 3)).astype(np.float32)
    xy, wh = rng.uniform(0.2, 0.5, (B, 2)), rng.uniform(0.15, 0.35, (B, 2))
    b["gt_xywh"] = np.concatenate([xy, wh], 1).astype(np.float32)
    if score:
        b["gt_xyxy"] = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        b["labels"] = np.array([1.0, 0.0], np.float32)
    return b


def _jax_clipped_grads(jm, variables, batch, score, cfg):
    """The gradients that enter JAX's AdamW: `jax.grad` of make_train_step's
    loss on the same batch (its forward's arguments; drop path is 0, so its
    random streams change nothing), clipped as optax clips them. Returns
    (the port's names -> gradient, the global norm before the clip)."""
    b = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out, _ = jm.apply(dict(variables, params=params), b["template"], b["online_template"],
                          b["search"], run_score_head=score, gt_bboxes=b.get("gt_xyxy"),
                          deterministic=score, train=not score, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(1),
                                "droppath": jax.random.PRNGKey(2)})
        if score:
            return jax_score_loss(out["pred_scores"], b["labels"],
                                  cfg.TRAIN.get("SCORE_WEIGHT", 1.0))[0]
        return jax_box_losses(out["pred_boxes"], b["gt_xywh"], 2.0, 5.0)[0]

    with jax.default_matmul_precision("highest"):
        grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    norm = float(optax.global_norm(grads))
    clipped, _ = optax.clip_by_global_norm(cfg.TRAIN.GRAD_CLIP_NORM).update(grads, None)
    return from_jax_variables({"params": jax.device_get(clipped)}), norm


def _assert_clipped_grads_close(got: dict, want: dict, clipped_norm: float):
    """The three gradient bounds of the module docstring."""
    assert got.keys() == want.keys()
    floor, total = 1e-6 * clipped_norm, 0.0
    for name, g in got.items():
        g, w = g.double().numpy(), want[name].double().numpy()
        err = np.linalg.norm(g - w)
        total += err ** 2
        assert err <= 1e-3 * np.linalg.norm(w) + floor, (name, err, np.linalg.norm(w))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-2 * np.abs(w).max() + floor,
                                   err_msg=name)
    assert np.sqrt(total) <= 1e-4 * clipped_norm, (np.sqrt(total), clipped_norm)


@pytest.mark.parametrize("script", ["mixformer_vit", "mixformer_vit_online"],
                         ids=["box_step", "stage2_step"])
def test_train_step_matches_jax(script):
    """One f32 step of each recipe's regime (the box step of mixformer_vit's
    baseline; stage 2 of mixformer_vit_online's, TRAIN_SCORE with its frozen
    BN head) from the same weights on the same batch: the metrics, the
    clipped gradients leaf by leaf, and the parameters after the update."""
    score = script.endswith("online")
    spec = dict(TINY, drop_path_rate=0.0, head_freeze_bn=score)
    jm = jax_mf.MixFormer(spec=jax_mf.ViTSpec(**spec), with_score=score)
    t, s = jnp.zeros((1, T_SZ, T_SZ, 3)), jnp.zeros((1, S_SZ, S_SZ, 3))
    variables = _randomise(jax.jit(lambda r: jm.init(r, t, t, s, run_score_head=score))(
        jax.random.PRNGKey(6)), 6)
    jcfg, pcfg = _cfg(jax_default_config, script), _cfg(get_default_config, script)
    assert pcfg.TRAIN.get("TRAIN_SCORE", False) == score and pcfg.MODEL.HEAD_FREEZE_BN == score
    batch = _batch(7, score)

    tx = jax_opt.make_optimizer(jcfg, variables["params"], steps_per_epoch=10)
    step = jax_ts.make_train_step(jm, tx, rgbt=False, train_score=score,
                                  score_weight=jcfg.TRAIN.get("SCORE_WEIGHT", 1.0))
    new, want = step(jax_ts.TrainState.create(variables, tx),
                     {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    want = {k: float(v) for k, v in want.items()}
    want_sd = from_jax_variables({"params": jax.device_get(new.params),
                                  "batch_stats": jax.device_get(new.batch_stats)})
    want_grads, norm = _jax_clipped_grads(jm, variables, batch, score, jcfg)
    np.testing.assert_allclose(norm, want["grad_norm"], rtol=1e-5)

    pm = port_mf.MixFormer(port_mf.ViTSpec(**spec), with_score=score)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
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
    assert got["grad_norm"] > clip                 # the step clipped
    _assert_clipped_grads_close(grads, want_grads, clip)
    lab, mults = port_opt._regime_labeler(pcfg)
    after = pm.state_dict()
    for name, v in after.items():
        group = lab(name) if name in named else None
        if name.endswith("num_batches_tracked"):
            continue
        if group is None or mults[group] < 0:
            if group is not None or score:      # frozen, and stage 2's BN statistics
                assert torch.equal(v, before[name]), name
            else:                               # the box step's BN statistics
                np.testing.assert_allclose(v.double().numpy(), want_sd[name].double().numpy(),
                                           atol=1e-5, rtol=1e-5, err_msg=name)
            continue
        g, w = v.numpy(), want_sd[name].numpy()
        big = np.abs(grads[name].numpy()) >= 1e-6
        np.testing.assert_allclose(g[big], w[big], atol=1e-6, rtol=1e-6, err_msg=name)
        assert np.abs(g - w).max() <= 2 * pcfg.TRAIN.LR * mults[group], name
        assert not big.any() or not np.array_equal(g[big], before[name].numpy()[big]), name
    if score:
        assert all(lab(n) == "main" for n in named if "score" in n)


# ------------------------------------------------------------- checkpoints
@pytest.fixture(scope="module")
def online_model():
    jm = jax_mf.MixFormer(spec=jax_mf.ViTSpec(**TINY), with_score=True)
    t, s = jnp.zeros((1, T_SZ, T_SZ, 3)), jnp.zeros((1, S_SZ, S_SZ, 3))
    return _randomise(jax.jit(lambda r: jm.init(r, t, t, s, run_score_head=True))(
        jax.random.PRNGKey(8)), 8)


@pytest.mark.parametrize("fmt", ["reference_pth", "jax_msgpack"])
def test_checkpoints_load_strictly(online_model, tmp_path, fmt):
    """A `.pth.tar` in the reference's trainer layout (`net`, DDP's
    `module.` prefix, a pickled settings object beside the weights, loaded
    through the restricted unpickler) and a JAX TrainState `.msgpack` load
    strictly into MixFormer with the score branch, the same bits; one
    missing tensor raises."""
    want = from_jax_variables(online_model)
    if fmt == "reference_pth":
        path = str(tmp_path / "MixFormerOnlineScore_ep0040.pth.tar")
        torch.save({"net": {f"module.{k}": v for k, v in want.items()},
                    "settings": argparse_namespace(), "epoch": 40}, path)
    else:
        path = str(tmp_path / "MixFormer_ep0040.msgpack")
        state = jax_ts.TrainState.create(online_model, optax.sgd(0.1))
        with open(path, "wb") as f:
            f.write(serialization.to_bytes({"state": state, "epoch": 40}))
    pm = port_mf.MixFormer(port_mf.ViTSpec(**TINY), with_score=True)
    report = load_variables(path, pm, strict=True)
    got = pm.state_dict()
    assert report["loaded"] == len(got) and not report["missing"]
    assert all(torch.equal(got[k], want[k]) for k in want)
    partial = port_mf.MixFormer(port_mf.ViTSpec(**TINY), with_score=True)
    if fmt == "reference_pth":
        torch.save({"net": {k: v for k, v in want.items() if "score_branch" not in k}}, path)
        with pytest.raises(ValueError, match="strict"):
            load_variables(path, partial, strict=True)


def argparse_namespace():
    """A pickled object of the reference trainer's file (its settings)."""
    import argparse
    return argparse.Namespace(script="mixformer_vit_online", lr=1e-4)


# ------------------------------------------------------------------- build
@pytest.mark.parametrize("script", list(RECIPES))
def test_every_recipe_builds(script):
    """Each unimodal recipe builds through build_model at the tiny geometry
    (spec_overrides), its head and score branch from the recipe."""
    for recipe in RECIPES[script]:
        cfg = _cfg(get_default_config, script, recipe)
        m = build_model(script, cfg, device="cpu",
                        spec_overrides=dict(TINY, head_type=cfg.MODEL.HEAD_TYPE))
        assert type(m) is port_mf.MixFormer and m.with_score == script.endswith("online")
        assert m.spec.head_freeze_bn == cfg.MODEL.get("HEAD_FREEZE_BN", False)
        with torch.no_grad():
            t, s = torch.zeros(1, T_SZ, T_SZ, 3), torch.zeros(1, S_SZ, S_SZ, 3)
            assert torch.isfinite(m(t, t, s)["pred_boxes"]).all()


LARGE = [("mixformer_vit", "mixformer_vit", "baseline_large"),
         ("mixformer_vit_online", "mixformer_vit_online", "baseline_large"),
         ("mixformer_vit_rgbt", "mixformer_vit_rgbt", "baseline_large")]


def _jax_large(script, cfg):
    if script.startswith("mixformer_vit_rgbt"):
        spec = jax_vr.VitRGBTSpec(base=jax_as.RGBTSpec.from_cfg(cfg), variant="two_stream")
        model, lead = jax_vr.MixFormerViTRGBT(spec=spec), 2
    else:
        model, lead = jax_mf.MixFormer(spec=jax_mf.ViTSpec.from_cfg(cfg),
                                       with_score=script.endswith("online")), 1
    ts, ss = cfg.DATA.TEMPLATE.SIZE, cfg.DATA.SEARCH.SIZE
    t = jax.ShapeDtypeStruct((lead, ts, ts, 3), jnp.float32)
    s = jax.ShapeDtypeStruct((lead, ss, ss, 3), jnp.float32)
    return jax.eval_shape(lambda a, b, c: model.init(jax.random.PRNGKey(0), a, b, c,
                                                     run_score_head=True), t, t, s)


@pytest.mark.parametrize("script,cfg_script,recipe", LARGE, ids=[x[0] for x in LARGE])
def test_vit_large_parameters_match_jax(script, cfg_script, recipe):
    """The ViT-L recipes (1024 wide, 24 deep, 16 heads) at full width, built
    on the meta device (no weights allocated) against jax.eval_shape of the
    JAX model: every tensor's element count through the JAX converter's
    name map, and the totals."""
    pcfg = _cfg(get_default_config, cfg_script, recipe)
    assert pcfg.MODEL.VIT_TYPE == "large_patch16"
    with torch.device("meta"):
        pm = (build_vit_rgbt(pcfg) if script.startswith("mixformer_vit_rgbt") else
              port_mf.build_mixformer_vit(pcfg, with_score=script.endswith("online")))
    shapes = _jax_large(script, _cfg(jax_default_config, cfg_script, recipe))
    flat = {"/".join((c,) + tuple(str(getattr(k, "key", k)) for k in path)): leaf.size
            for c in shapes
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes[c])[0]}
    seen = set()
    for name, p in list(pm.named_parameters()) + list(pm.named_buffers()):
        if "pos_embed" in name or name.endswith("num_batches_tracked"):
            continue
        cands = map_torch_key(name, frozen_head_bn=pcfg.MODEL.get("HEAD_FREEZE_BN", False))
        cands = cands if isinstance(cands, list) else [cands]
        # the converter's candidates for one key: the first that exists
        key = next(k for k in ("/".join((c,) + tuple(p_)) for c, p_, _ in cands) if k in flat)
        assert flat[key] == p.numel() and key not in seen, (name, key)
        seen.add(key)
    assert seen == set(flat)
    n_port = sum(p.numel() for p in pm.parameters())
    assert n_port == sum(v for k, v in flat.items() if k.startswith("params/"))
    backbone = pm.backbone_v if script.startswith("mixformer_vit_rgbt") else pm.backbone
    assert len(backbone.blocks) == 24 and backbone.blocks[0].attn.num_heads == 16
