"""Stage 2 of the online scripts (TRAIN_SCORE): the port's training step of
the SPM score branch against the JAX package's
`make_train_step(train_score=True)`, one step from the same weights on the
same batch, with the online recipe's optimizer (only the score branch
trains) on the scored tiny flagship of tests/test_torch_port_spm.py, batch
2 (one positive and one negative label).

Both sides run the whole net in eval mode under autograd and clip by the
global norm of EVERY gradient, the frozen ones included, before the
frozen groups' updates are zeroed (JAX: `clip_by_global_norm` then
`multi_transform` with `set_to_zero`). The backbone and fusion get
gradients through the score branch's inputs, so their norm sets the clip
scale; the second case sets GRAD_CLIP_NORM between the score branch's own
gradient norm and the global one, where a step that dropped the frozen
gradients would not clip at all.

Tolerances:
  * the loss 1e-5 relative;
  * grad_norm 5e-5 relative. The norm is dominated by the frozen fusion's
    and backbone's gradients, and both sides' f32 gradients lie about 3e-4
    of the norm from the exact ones (the box step's ReLU and sampling
    switches, tests/test_torch_port_train_step.py); on this batch the two
    f32 norms are 2.1e-5 apart;
  * the score parameters after the update 1e-6 (absolute and relative;
    one update of the recipe's lr 1e-4), where the clipped gradient is at
    least 1e-6. Adam's first step moves a parameter by lr g / (|g| + eps),
    eps 1e-8, so where g is within a hundred eps of zero (the key
    projections' biases, whose exact gradient is zero as softmax ignores a
    shift of every logit, and products with near-zero activations) the
    update turns the rounding of g itself into up to lr: there the two
    sides agree within 2 lr, the most their two first steps can differ;
  * every other parameter and every BatchNorm statistic the same bits as
    before the step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.config import get_default_config as jax_default_config
from multi_modal_tracking_tpu.train import optimizer as jax_opt
from multi_modal_tracking_tpu.train import train_step as jax_ts

from multi_modal_tracking_torch.config import get_default_config
from multi_modal_tracking_torch.train import optimizer as port_opt
from multi_modal_tracking_torch.train import train_step as port_ts
from multi_modal_tracking_torch.utils.convert import from_jax_variables

from tests.test_torch_port_batched import one_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_port_model import S_SZ, T_SZ
from tests.test_torch_port_spm import score_pair

SCRIPT = "asymmetric_shared_online"
RECIPE = f"experiments/{SCRIPT}/attention_lasher_newfusion_2layer.yaml"
B = 2


@pytest.fixture(scope="module")
def pair():
    return score_pair(7)


def _cfgs(clip):
    out = []
    for get in (jax_default_config, get_default_config):
        c = get(SCRIPT)
        c.update_from_file(RECIPE)
        c.TRAIN.GRAD_CLIP_NORM = clip
        out.append(c)
    return out


def _batch(seed):
    rng = np.random.default_rng(seed)
    b = {k: rng.standard_normal((B, T_SZ, T_SZ, 3)).astype(np.float32)
         for k in ("template_v", "template_i", "online_template_v", "online_template_i")}
    b.update({k: rng.standard_normal((B, S_SZ, S_SZ, 3)).astype(np.float32)
              for k in ("search_v", "search_i")})
    xy, wh = rng.uniform(0.2, 0.5, (B, 2)), rng.uniform(0.15, 0.35, (B, 2))
    b["gt_xywh"] = np.concatenate([xy, wh], 1).astype(np.float32)
    b["gt_xyxy"] = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    b["labels"] = np.array([1.0, 0.0], np.float32)
    return b


def _jax_step(jmodel, variables, jcfg, batch):
    tx = jax_opt.make_optimizer(jcfg, variables["params"], steps_per_epoch=10)
    step = jax_ts.make_train_step(jmodel, tx, train_score=True,
                                  score_weight=jcfg.TRAIN.SCORE_WEIGHT)
    state = jax_ts.TrainState.create(variables, tx)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
    return (from_jax_variables({"params": jax.device_get(new.params)}),
            {k: float(v) for k, v in metrics.items()})


def _port_step(pmodel, variables, pcfg, batch):
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    before = {k: v.clone() for k, v in pmodel.state_dict().items()}
    opt = port_opt.make_optimizer(pcfg, pmodel, steps_per_epoch=10)
    step = port_ts.make_train_step(pmodel, opt, device="cpu", train_score=True,
                                   score_weight=pcfg.TRAIN.SCORE_WEIGHT)
    metrics = {k: float(v) for k, v in step(batch).items()}
    return before, metrics, opt


@pytest.mark.parametrize("clip", ["recipe", "between"])
def test_score_step_matches_jax(pair, clip):
    jmodel, variables, pmodel = pair
    batch = _batch(3)
    named = dict(pmodel.named_parameters())
    score = [n for n in named if n.startswith("score_branch.")]
    if clip == "between":
        # the port's unclipped gradients: GRAD_CLIP_NORM between the score
        # branch's own norm and the global one
        _, m, opt = _port_step(pmodel, variables, _cfgs(1e9)[1], batch)
        grads = dict(zip(named, opt.grads))
        own = float(torch.sqrt(sum((grads[n] ** 2).sum() for n in score)))
        assert own < 0.5 * m["grad_norm"], (own, m["grad_norm"])
        limit = (own * m["grad_norm"]) ** 0.5
        raw = {n: grads[n].clone() for n in score}
    else:
        limit = None
    jcfg, pcfg = _cfgs(limit if limit is not None else 0.1)
    want_params, want = _jax_step(jmodel, variables, jcfg, batch)
    before, got, opt = _port_step(pmodel, variables, pcfg, batch)

    assert got.keys() == want.keys() == {"Loss/total", "Loss/scores", "grad_norm"}
    np.testing.assert_allclose(got["Loss/total"], want["Loss/total"], rtol=1e-5)
    np.testing.assert_allclose(got["Loss/scores"], want["Loss/scores"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=5e-5)
    assert got["grad_norm"] > pcfg.TRAIN.GRAD_CLIP_NORM          # the step clipped
    after = pmodel.state_dict()
    grads = dict(zip(named, opt.grads))
    lr = pcfg.TRAIN.LR
    for name, v in after.items():
        if name in score:
            g, w = v.numpy(), want_params[name].numpy()
            big = np.abs(grads[name].numpy()) >= 1e-6
            np.testing.assert_allclose(g[big], w[big], atol=1e-6, rtol=1e-6, err_msg=name)
            assert np.abs(g - w).max() <= 2 * lr, name
            assert not torch.equal(v, before[name]), name
        else:
            assert torch.equal(v, before[name]), name               # frozen, BN statistics
    if limit is not None:
        # the score branch's gradients were scaled by limit / global norm
        # (their own norm alone is under the limit)
        for n in score:
            torch.testing.assert_close(grads[n], raw[n] * (limit / got["grad_norm"]),
                                       rtol=1e-5, atol=1e-12)
    # the frozen net got gradients, through K2 / K4's plain versions here
    for n in ("backbone.blocks.0.attn.qkv.weight",
              "fusion_vi.fusion_attention.encoder.layers.0.self_attn.value_proj.weight"):
        assert float(grads[n].abs().max()) > 0.0, n
