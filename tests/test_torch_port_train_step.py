"""The port's training step (multi_modal_tracking_torch.train) against the
JAX package's, on the same weights and batch, at the tiny geometry that
tests/test_torch_port_model.py holds against JAX (width 64, 4 heads, depth
4, CE at blocks 1/3, template 112, search 176, CORNER_UP head, LNSpecific
fusion with 2 layers), batch 2. The weights are perturbed with that test's
`_randomise`, so the zero-initialised MSDA offset and attention-weight
kernels get real gradients.

JAX side: `jax.grad` of the package's own `box_losses` over
`model.apply(..., deterministic=True, train=True, mutable=["batch_stats"])`,
i.e. `make_train_step`'s loss_fn with dropout and drop path off (their
random streams cannot match across frameworks); port side: the model in
training mode with both drop rates at 0, `box_losses`, `loss.backward()`.

Tolerances:
  * loss and the metrics: 1e-5 rel; the global grad norm: 1e-3 rel;
  * the gradients g against JAX's w, both f32 (JAX at "highest" matmul
    precision), with G the global grad norm:
      ||g - w|| <= 1e-2 G                     (all parameters together)
      ||g - w|| <= 5e-2 ||w|| + 1e-6 G        (each tensor, Frobenius)
      |g - w|   <= 1e-1 max|w| + 1e-6 G       (every element)
    The gradient is not a continuous function of the inputs: ReLU (fusion
    FFN, head) and the floor that picks MSDA's bilinear corners switch where
    an input crosses 0 or a pixel centre, so forward values that differ in
    the last bits flip a few switches, and the head's training-mode
    BatchNorms over a few pixels amplify rounding (flax computes the batch
    variance as E[x^2] - E[x]^2). Measured against the port run in float64
    on the same batch: all together the port's f32 gradients are within
    1e-5 G (keep 1) and 1.6e-3 G (keep 0.7) of it, JAX's within 1.7e-3 G
    and 5.8e-3 G; per tensor the port's within 6e-3 and JAX's within 2.1e-2
    (a head BatchNorm bias at keep 0.7); single elements within 4 % of
    their tensor's largest gradient. A relative perturbation of 1e-7 of the
    input images moves the port's per-tensor gradients by up to 5e-3. CE's top-k keeps the same
    tokens on both sides: the smallest relative gap between the last kept
    and the first dropped score is 7e-5 on this batch. The 1e-6 G floor
    covers gradients that are exactly zero and come out as rounding noise:
    conv biases in front of a training-mode BatchNorm and the score
    convolution's bias in front of the soft-argmax. A dropped gradient
    path (attention or MSDA without a backward) or a wrong mask gives
    errors of order 1 on every scale;
  * BatchNorm running statistics after the step: 1e-5 abs + 1e-5 rel;
  * the optimizer against optax over 3 steps: 1e-6 abs + 1e-6 rel on the
    parameters (one ulp-level rounding per update).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_modal_tracking_tpu.config import get_default_config as jax_default_config
from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as
from multi_modal_tracking_tpu.models import heads as jax_heads
from multi_modal_tracking_tpu.models.layers import DropPath as JaxDropPath
from multi_modal_tracking_tpu.train import optimizer as jax_opt
from multi_modal_tracking_tpu.train import train_step as jax_ts
from multi_modal_tracking_tpu.train.losses import box_losses as jax_box_losses

from multi_modal_tracking_torch.config import get_default_config
from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.models import heads as port_heads
from multi_modal_tracking_torch.models.layers import (BatchNorm2d, DropPath, Dropout,
                                                      set_generator)
from multi_modal_tracking_torch.train import optimizer as port_opt
from multi_modal_tracking_torch.train import train_step as port_ts
from multi_modal_tracking_torch.train.losses import box_losses
from multi_modal_tracking_torch.utils.convert import from_jax_variables
from tests.test_torch_port_model import GEOM, S_SZ, T_SZ, _randomise

RECIPE = "experiments/asymmetric_shared_ce/attention_lasher_newfusion_2layer.yaml"
B = 2


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_as.MixFormerRGBT(spec=jax_as.RGBTSpec(**GEOM))
    tz = jnp.zeros((2, T_SZ, T_SZ, 3), jnp.float32)
    sz = jnp.zeros((2, S_SZ, S_SZ, 3), jnp.float32)
    variables = _randomise(jax.jit(jmodel.init)(jax.random.PRNGKey(0), tz, tz, sz), 0)
    pmodel = port_as.MixFormerRGBT(port_as.RGBTSpec(**GEOM, drop_path_rate=0.0,
                                                    fusion_dropout=0.0))
    return jmodel, variables, pmodel


def _batch(seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((2 * B, T_SZ, T_SZ, 3)).astype(np.float32)
    ot = rng.standard_normal((2 * B, T_SZ, T_SZ, 3)).astype(np.float32)
    s = rng.standard_normal((2 * B, S_SZ, S_SZ, 3)).astype(np.float32)
    xy = rng.uniform(0.2, 0.5, (B, 2))
    wh = rng.uniform(0.15, 0.35, (B, 2))
    return t, ot, s, np.concatenate([xy, wh], 1).astype(np.float32)


def assert_grads_close(model, want_grads, grad_norm):
    """The three bounds of the module docstring."""
    named = dict(model.named_parameters())
    assert named.keys() == want_grads.keys()
    floor = 1e-6 * grad_norm
    total = 0.0
    for name, p in named.items():
        assert p.grad is not None, name
        g, w = p.grad.numpy().astype(np.float64), want_grads[name].numpy().astype(np.float64)
        err = np.linalg.norm(g - w)
        total += err ** 2
        assert err <= 5e-2 * np.linalg.norm(w) + floor, (name, err, np.linalg.norm(w))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-1 * np.abs(w).max() + floor,
                                   err_msg=name)
    assert np.sqrt(total) <= 1e-2 * grad_norm, (np.sqrt(total), grad_norm)


def _jax_grads(jmodel, variables, batch, keep):
    t, ot, s, gt = (jnp.asarray(x) for x in batch)

    def loss_fn(params, bs):
        out, mutated = jmodel.apply({"params": params, "batch_stats": bs}, t, ot, s, keep,
                                    deterministic=True, train=True, mutable=["batch_stats"])
        loss, metrics = jax_box_losses(out["pred_boxes"], gt, 2.0, 5.0)
        return loss, (metrics, mutated["batch_stats"])

    grads, (metrics, stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    metrics = {k: float(v) for k, v in metrics.items()}
    metrics["grad_norm"] = float(optax.global_norm(grads))
    return jax.device_get(grads), metrics, jax.device_get(stats)


def _port_grads(pmodel, variables, batch, keep):
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    pmodel.train()
    pmodel.zero_grad(set_to_none=True)
    t, ot, s, gt = (torch.from_numpy(x) for x in batch)
    out = pmodel(t, ot, s, keep)
    loss, metrics = box_losses(out["pred_boxes"], gt, 2.0, 5.0)
    loss.backward()
    metrics = {k: float(v.detach()) for k, v in metrics.items()}
    metrics["grad_norm"] = float(torch.sqrt(sum((p.grad ** 2).sum()
                                                for p in pmodel.parameters())))
    return metrics


@pytest.mark.parametrize("keep", [1.0, 0.7], ids=["keep_1", "keep_0.7"])
def test_step_gradients_match_jax(pair, keep):
    """Loss, the four metrics, the global grad norm, every parameter's
    gradient and the BN running statistics after the step. keep 0.7 runs
    CE's top-k, gather and zero-scatter under autograd."""
    jmodel, variables, pmodel = pair
    batch = _batch(1 if keep == 1.0 else 2)
    grads, want, stats = _jax_grads(jmodel, variables, batch, keep)
    got = _port_grads(pmodel, variables, batch, keep)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3 if k == "grad_norm" else 1e-5,
                                   err_msg=k)
    assert_grads_close(pmodel, from_jax_variables({"params": grads}), want["grad_norm"])
    named = dict(pmodel.named_parameters())
    for name in ("backbone.blocks.0.attn.qkv.weight",
                 "fusion_vi.fusion_attention.encoder.layers.0.self_attn.value_proj.weight",
                 "fusion_vi.fusion_attention.encoder.layers.0.self_attn.sampling_offsets.weight",
                 "fusion_vi.fusion_attention.encoder.layers.0.self_attn.attention_weights.weight"):
        assert float(named[name].grad.abs().max()) > 1e-6, name    # reached through K1/K3

    want_stats = from_jax_variables({"batch_stats": stats})
    buffers = dict(pmodel.named_buffers())
    for name, w in want_stats.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(buffers[name].numpy(), w.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_batchnorm_updates_running_var_with_biased_variance():
    """flax BatchNorm (momentum 0.9) updates running_var with the biased
    batch variance: values 0..7 from 1 give 0.9 + 0.1 * 5.25 = 1.425; torch's
    own BatchNorm2d would give 1.5."""
    bn = BatchNorm2d(1, eps=1e-5).train()
    bn(torch.arange(8, dtype=torch.float32).reshape(8, 1, 1, 1))
    assert float(bn.running_var[0]) == pytest.approx(1.425, abs=1e-6)
    assert float(bn.running_mean[0]) == pytest.approx(0.35, abs=1e-6)


def test_frozen_bn_head_matches_jax_and_stays_frozen():
    """HEAD_FREEZE_BN: the JAX frozen leaves (bn_scale, bn_bias, bn_mean,
    bn_var in batch_stats) map onto the port's FrozenBatchNorm2d; in
    training mode the head agrees with JAX, its BN statistics and affine do
    not move, and they are buffers (no gradient, no weight decay)."""
    x = np.random.default_rng(6).standard_normal((2, 6, 6, 48)).astype(np.float32)
    jh = jax_heads.PyramidCornerPredictor(channel=64, feat_sz=24, stride=4, freeze_bn=True)
    variables = _randomise(jh.init(jax.random.PRNGKey(0), x), 6)
    assert "bn_scale" in variables["batch_stats"]["tower_tl"]["conv1"]
    ph = port_heads.PyramidCornerPredictor(48, 64, 24, 4, freeze_bn=True)
    ph.load_state_dict(from_jax_variables(variables), strict=True)
    before = {k: v.clone() for k, v in ph.state_dict().items()}
    want, mutated = jh.apply(variables, x, train=True, mutable=["batch_stats"])
    ph.train()
    got = ph(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=0)
    got.sum().backward()
    for k, v in ph.state_dict().items():
        assert torch.equal(v, before[k]) or k.endswith((".weight", ".bias")) and \
            k in dict(ph.named_parameters()), k
    bn_names = [n for n, _ in ph.named_buffers() if n.endswith("running_var")]
    assert bn_names and not any(".1." in n or n.endswith(".1.weight")
                                for n, _ in ph.named_parameters() if "conv1_tl.1" in n)
    assert all(not n.startswith("conv1_tl.1") for n, _ in ph.named_parameters())


def _flagship_cfgs(drop_epoch):
    cfgs = []
    for get in (jax_default_config, get_default_config):
        c = get("asymmetric_shared_ce")
        c.update_from_file(RECIPE)
        c.TRAIN.LR_DROP_EPOCH = drop_epoch
        cfgs.append(c)
    return cfgs


def _optax_step(tx, grads, state, params):
    updates, state = tx.update(grads, state, params)
    return optax.apply_updates(params, updates), state


def test_optimizer_matches_optax_over_three_steps(pair):
    """Identical numpy gradients into the port's RegimeAdamW and the JAX
    package's `make_optimizer` (optax) with the flagship's
    RGBT_TRACK_SHARED regime: 3 steps, 2 per epoch and an LR drop after
    epoch 1, so the third step runs at 0.1x; steps 1 and 3 are clipped (norm
    > GRAD_CLIP_NORM 0.1), step 2 is not."""
    jmodel, variables, pmodel = pair
    jcfg, pcfg = _flagship_cfgs(drop_epoch=1)
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    opt = port_opt.make_optimizer(pcfg, pmodel, steps_per_epoch=2)
    params = variables["params"]
    tx = jax_opt.make_optimizer(jcfg, params, steps_per_epoch=2)
    state = tx.init(params)
    optax_step = jax.jit(lambda g_, s_, p_: _optax_step(tx, g_, s_, p_))
    rng = np.random.default_rng(7)
    norms = []
    for step, scale in enumerate((1e-2, 1e-5, 3e-2)):
        g = jax.tree.map(lambda a: (scale * rng.standard_normal(np.shape(a))).astype(np.float32),
                         params)
        port_g = from_jax_variables({"params": g})
        for name, p in pmodel.named_parameters():
            p.grad = port_g[name].clone()
        norms.append(float(opt.update()))
        params, state = optax_step(g, state, params)
        assert norms[-1] == pytest.approx(float(optax.global_norm(g)), rel=1e-5)
    assert norms[0] > 0.1 > norms[1] and norms[2] > 0.1
    want = from_jax_variables({"params": jax.device_get(params)})
    for name, p in pmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=name)


def test_regime_groups_match_jax_labels(pair):
    """Every parameter lands in the group the JAX labeler gives its flax
    path (blocks_{i}/ vs blocks.{i}.), for the flagship regime and for
    FREEZE_FIRST_6LAYERS."""
    _, variables, _ = pair
    for flag in ("RGBT_TRACK_SHARED", "FREEZE_FIRST_6LAYERS"):
        jcfg, pcfg = _flagship_cfgs(drop_epoch=120)
        for c in (jcfg, pcfg):
            c.TRAIN[flag] = True
        jlab, jm = jax_opt._regime_labeler(jcfg)
        plab, pm = port_opt._regime_labeler(pcfg)
        assert jm == pm
        flat = {"/".join(k): v for k, v in _flat(variables["params"])}
        jax_paths = {k: jlab(k) for k in flat}
        port = from_jax_variables({"params": {k: v for k, v in variables["params"].items()}})
        mapping = {}
        for path in flat:
            name = next(iter(from_jax_variables({"params": _nest(path, flat[path])})))
            mapping[name] = jax_paths[path]
        assert mapping.keys() == port.keys()
        for name, group in mapping.items():
            assert plab(name) == group, (flag, name)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _nest(path, leaf):
    out = leaf
    for k in reversed(path.split("/")):
        out = {k: out}
    return out


def test_keep_rate_schedules_match_jax():
    for epoch in (0, 5, 9, 10, 11, 25, 49, 50, 51, 150):
        for args in ((10, 50, 7, 0.7), (20, 100, 3, 0.5)):
            w, t, it, base = args
            assert port_ts.adjust_keep_rate(epoch, w, t, it, base_keep_rate=base) == \
                jax_ts.adjust_keep_rate(epoch, w, t, it, base_keep_rate=base)
    for rate in (None, 1.0, 0.99, 0.7, 0.75, 0.5, 0.31):
        for n in (324, 121, 64):
            assert port_ts.bucketize_keep_rate(rate, n) == jax_ts.bucketize_keep_rate(rate, n)
    assert port_ts.bucketize_keep_rate(0.7, 324) == 240 / 324


@pytest.mark.parametrize("sched", ["step", "Mstep", "warmup_cosine"])
def test_epoch_schedules_match_jax(sched):
    jcfg, pcfg = _flagship_cfgs(drop_epoch=3)
    for c in (jcfg, pcfg):
        c.TRAIN.SCHEDULER.TYPE = sched
        if sched == "Mstep":
            c.TRAIN.LR_DROP_EPOCH = [2, 5]
        c.TRAIN.WARMUP_EPOCHS, c.TRAIN.EPOCH, c.TRAIN.MIN_LR = 2, 10, 1e-6
    jf, pf = jax_opt.make_epoch_schedule(jcfg, 4), port_opt.make_epoch_schedule(pcfg, 4)
    for step in range(0, 45):
        # the JAX warmup-cosine runs in float32 (jnp), the port in float64
        assert pf(step) == pytest.approx(float(jf(step)), rel=1e-5, abs=1e-12), step


@pytest.mark.parametrize("cls", [DropPath, Dropout])
def test_random_layers_by_property(cls):
    """Zeroed entries (whole samples for DropPath) and the rest scaled by
    1 / keep; one generator seed gives one mask; eval mode and rate 0 are
    the identity; training mode without a generator raises."""
    x = torch.rand(64, 5, 7) + 0.5
    layer = cls(0.25).train()
    with pytest.raises(RuntimeError, match="generator"):
        layer(x)
    masks = []
    for _ in range(2):
        set_generator(layer, torch.Generator().manual_seed(3))
        masks.append(layer(x))
    torch.testing.assert_close(masks[0], masks[1], rtol=0, atol=0)
    y = masks[0]
    kept = y != 0
    torch.testing.assert_close(y[kept], (x / 0.75)[kept])
    assert 0.6 < float(kept.float().mean()) < 0.9
    if cls is DropPath:
        per_sample = kept.reshape(64, -1)
        assert bool((per_sample.all(1) | ~per_sample.any(1)).all())
        # the JAX layer draws the same shape of mask
        jd = JaxDropPath(0.25).apply({}, jnp.asarray(x.numpy()), False,
                                     rngs={"droppath": jax.random.PRNGKey(0)})
        jk = np.asarray(jd) != 0
        assert (jk.reshape(64, -1).all(1) | ~jk.reshape(64, -1).any(1)).all()
    assert torch.equal(layer.eval()(x), x)
    assert torch.equal(cls(0.0).train()(x), x)


def test_model_train_mode_uses_generator(pair):
    """With drop path and dropout on, a training forward needs the generator
    and one seed reproduces the output."""
    spec = dataclasses.replace(port_as.RGBTSpec(**GEOM), drop_path_rate=0.1, fusion_dropout=0.1)
    model = port_as.MixFormerRGBT(spec).train()
    t, ot, s, _ = (torch.from_numpy(x) for x in _batch(3))
    with pytest.raises(RuntimeError, match="generator"):
        model(t, ot, s, 1.0)
    outs = []
    for _ in range(2):
        set_generator(model, torch.Generator().manual_seed(5))
        with torch.no_grad():
            outs.append(model(t, ot, s, 1.0)["pred_boxes"])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
