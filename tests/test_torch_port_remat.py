"""TRAIN.REMAT in the port (models/asymmetric_shared.py, models/layers.py
`remat`): the counterparts of tests/test_remat.py at its geometry (search
64, template 32, width 64, depth 3, CE at block 1, one fusion layer) and
drop_path_rate 0.1, where the recomputed blocks must replay the masks the
forward drew from the explicit generator.

  * remat's loss and gradients equal the plain model's with the same
    generator seed (tests/test_remat.py:47: loss 1e-6 rel, gradients
    1e-5), and the generator ends in the same state;
  * the full forward is unchanged by remat and the cached tracking path
    (which never remats) follows it (tests/test_remat.py:56);
  * RGBTSpec.from_cfg reads TRAIN.REMAT (tests/test_remat.py:67), and a
    script without a remat path trains without it, as in the JAX package;
  * the port's remat step against the JAX package's remat model
    (`nn.remat(SharedBlock)`), deterministic on both sides, with the
    tolerances of tests/test_torch_port_train_step.py::
    test_step_gradients_match_jax.
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
from multi_modal_tracking_tpu.train.losses import box_losses as jax_box_losses

from multi_modal_tracking_torch.config import get_default_config
from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.models.layers import set_generator
from multi_modal_tracking_torch.train.losses import box_losses
from multi_modal_tracking_torch.utils.convert import from_jax_variables
from tests.test_torch_port_batched import one_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_port_model import _randomise
from tests.test_torch_port_train_step import assert_grads_close

SPEC = dict(search_size=64, template_size=32, embed_dim=64, depth=3, num_heads=2,
            head_dim=64, fusion_layers=1, ce_loc=(1,), ce_keep_ratio=(0.7,))


@pytest.fixture(scope="module")
def jax_pair():
    cfg = jax_default_config("asymmetric_shared_ce")
    spec = dataclasses.replace(jax_as.RGBTSpec.from_cfg(cfg), **SPEC, drop_path_rate=0.1)
    model = jax_as.MixFormerRGBT(spec=spec)
    model_r = jax_as.MixFormerRGBT(spec=dataclasses.replace(spec, remat=True))
    rng = np.random.default_rng(0)
    t = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    s = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables = _randomise(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(t),
                                               jnp.asarray(t), jnp.asarray(s)), 3)
    return model, model_r, variables, t, s


def _port(variables, remat, drop_path_rate=0.1):
    cfg = get_default_config("asymmetric_shared_ce")
    spec = dataclasses.replace(port_as.RGBTSpec.from_cfg(cfg), **SPEC, remat=remat,
                               drop_path_rate=drop_path_rate, fusion_dropout=0.0)
    m = port_as.MixFormerRGBT(spec)
    m.load_state_dict(from_jax_variables(variables), strict=True)
    return m


def _loss_and_grads(model, t, s, seed=6):
    """sum(pred_boxes^2) in training mode at keep 0.7, masks from `seed`."""
    g = torch.Generator().manual_seed(seed)
    set_generator(model, g)
    model.train()
    model.zero_grad(set_to_none=True)
    tt, ss = torch.from_numpy(t), torch.from_numpy(s)
    loss = (model(tt, tt, ss, 0.7)["pred_boxes"] ** 2).sum()
    loss.backward()
    return float(loss), {k: p.grad.clone() for k, p in model.named_parameters()
                         if p.grad is not None}, g.get_state()


def test_remat_same_loss_and_grads(jax_pair):
    _, _, variables, t, s = jax_pair
    plain, remat = _port(variables, False), _port(variables, True)
    assert plain.spec.drop_path_rate == 0.1 and remat.backbone.remat
    l0, g0, s0 = _loss_and_grads(plain, t, s)
    l1, g1, s1 = _loss_and_grads(remat, t, s)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    assert g0.keys() == g1.keys() and len(g0) > 50
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), atol=1e-5, err_msg=k)
    # the same draws: the recomputation read the tape, not the generator
    assert torch.equal(s0, s1)
    # and the masks did drop samples (another seed changes the loss)
    assert _loss_and_grads(plain, t, s, seed=7)[0] != l0


def test_remat_cached_paths_and_full_forward(jax_pair):
    _, _, variables, t, s = jax_pair
    plain, remat = _port(variables, False).eval(), _port(variables, True).eval()
    tt, ss = torch.from_numpy(t), torch.from_numpy(s)
    with torch.no_grad():
        full = plain(tt, tt, ss, 0.7)["pred_boxes"]
    full_r = remat(tt, tt, ss, 0.7)["pred_boxes"]         # grad mode: remat runs
    np.testing.assert_allclose(full_r.detach().numpy(), full.numpy(), atol=1e-6)
    with torch.no_grad():
        out = remat.forward_track(remat.set_online(tt, tt), ss, 0.7)["pred_boxes"]
    np.testing.assert_allclose(out.numpy(), full.numpy(), atol=1e-5)


def test_remat_from_cfg(tmp_path):
    cfg = get_default_config("asymmetric_shared_ce")
    assert port_as.RGBTSpec.from_cfg(cfg).remat is False
    cfg.TRAIN.REMAT = True
    assert port_as.RGBTSpec.from_cfg(cfg).remat is True
    assert port_as.build_mixformer_rgbt(cfg, embed_dim=64, depth=2, num_heads=2,
                                        head_dim=64).backbone.remat
    # the JAX package reads TRAIN.REMAT in the flagship's builder alone
    jcfg = jax_default_config("mixformer_vit")
    jcfg.TRAIN.REMAT = True
    from multi_modal_tracking_tpu.models.mixformer import build_mixformer_vit
    assert "remat" not in {f.name for f in dataclasses.fields(build_mixformer_vit(jcfg).spec)}


def test_remat_matches_jax_remat_step(jax_pair):
    _, jmodel_r, variables, t, s = jax_pair
    rng = np.random.default_rng(4)
    gt = np.concatenate([rng.uniform(0.2, 0.5, (1, 2)), rng.uniform(0.15, 0.35, (1, 2))],
                        1).astype(np.float32)

    def loss_fn(params):
        out, _ = jmodel_r.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                t, t, s, 0.7, deterministic=True, train=True,
                                mutable=["batch_stats"])
        loss, metrics = jax_box_losses(out["pred_boxes"], gt, 2.0, 5.0)
        return loss, metrics
    grads, metrics = jax.jit(jax.grad(loss_fn, has_aux=True))(variables["params"])
    grad_norm = float(optax.global_norm(grads))

    model = _port(variables, True, drop_path_rate=0.0).train()
    out = model(torch.from_numpy(t), torch.from_numpy(t), torch.from_numpy(s), 0.7)
    loss, got = box_losses(out["pred_boxes"], torch.from_numpy(gt), 2.0, 5.0)
    loss.backward()
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    assert_grads_close(model, from_jax_variables({"params": jax.device_get(grads)}), grad_norm)
