"""The port's Alpha-Refine training (train/refine.py) and the classic
trackers' losses (train/losses.py) on the CPU against the JAX package's.

One refine step at input 64 with 32 x 32 masks (so the target resize with
antialias runs), batch 2 (a box target and a real-mask target), AdamW lr
1e-3, weight decay 1e-4 on every leaf: the JAX package's
`make_refine_train_step` against `RefineTrainer.step` from the same
seeded variables (tests/torch_port_alpha_refine_common.py). JAX's first
moment after one step is (1 - b1) g, so its opt_state gives the
gradients, FrozenBatchNorm leaves included (the JAX step trains them).

Tolerances:
  * loss and its two terms 1e-5 relative;
  * first moments (the gradients) 2e-4 of each leaf's largest magnitude
    (ResNet-50's backward sums round in other orders);
  * updated leaves 5e-5 absolute on all but 1e-4 of the entries (364 of
    26.0 M when written), and
    every entry within 2 lr: AdamW's first step moves an entry by
    lr g / (|g| + eps), so an entry whose gradient is at the rounding noise
    of the backward (near eps, or a sign apart) moves by up to lr either
    way;
  * `batch_from_box_dataset` bit for bit (uint8 crops through cv2 on the
    JAX side);
  * the losses 1e-6 relative.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_modal_tracking_tpu.train import losses as jax_losses
from multi_modal_tracking_tpu.train import refine as jax_refine

from multi_modal_tracking_torch.train import losses as port_losses
from multi_modal_tracking_torch.train import refine as port_refine
from multi_modal_tracking_torch.utils.checkpoint import load_variables
from multi_modal_tracking_torch.utils.convert import from_jax_variables

from tests import torch_port_alpha_refine_common as common
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

S = common.INPUT_SZ
LR, WD = 1e-3, 1e-4


def _samples(seed):
    """A box target (the block) and a real-mask target (an ellipse), the
    second box partly outside the frame."""
    frames, boxes = common.frame_sequence(3, seed=seed)
    h, w = frames[0].shape[:2]
    yy, xx = np.mgrid[:h, :w]
    mask = (((xx - 140.0) / 22.0) ** 2 + ((yy - 100.0) / 15.0) ** 2 <= 1.0).astype(np.float32)
    return [(frames[0], np.asarray(boxes[0], np.float32), frames[1],
             np.asarray(boxes[1], np.float32)),
            (frames[1], np.asarray([130.0, 95.0, 40.0, 30.0], np.float32), frames[2], mask)]


def test_batch_from_box_dataset_bit_for_bit():
    rng = np.random.default_rng(0)
    want = jax_refine.batch_from_box_dataset(_samples(1), S, rng)
    got = port_refine.batch_from_box_dataset(_samples(1), S, rng)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 0.0 < got["test_masks"][1].mean() < 0.5


@pytest.fixture(scope="module")
def one_step():
    """The JAX step and the port's from the same variables and batch."""
    net, variables = common.jax_alpha_refine(32)
    batch = jax_refine.batch_from_box_dataset(_samples(1), S, None)
    tx = optax.adamw(LR, weight_decay=WD)
    state = jax_refine.RefineTrainState(variables=variables, opt_state=tx.init(variables),
                                        step=jnp.asarray(0))
    new_state, metrics = jax_refine.make_refine_train_step(net, tx)(state, batch)
    trainer = port_refine.RefineTrainer(common.port_alpha_refine(32), lr=LR, weight_decay=WD)
    before = {n: t.detach().clone() for n, t in zip(trainer.names, trainer.leaves)}
    got = trainer.step(batch)
    return dict(want={k: float(v) for k, v in metrics.items()}, got=got, trainer=trainer,
                before=before, mu=from_jax_variables(jax.device_get(new_state.opt_state[0].mu)),
                after=from_jax_variables(jax.device_get(new_state.variables)))


def test_refine_step_loss_matches_jax(one_step):
    for k in ("loss", "mask_bce", "mask_soft_iou"):
        np.testing.assert_allclose(one_step["got"][k], one_step["want"][k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("which", ["gradients", "updated"])
def test_refine_step_leaves_match_jax(one_step, which):
    """Every leaf the JAX step trains, the four FrozenBatchNorm leaves of
    each BN included, has the port's first moment (gradient) and updated
    value; the BN leaves moved."""
    tr = one_step["trainer"]
    want = one_step["mu" if which == "gradients" else "after"]
    got = dict(zip(tr.names, tr.mu if which == "gradients" else tr.leaves))
    assert set(got) == set(want)
    bn = [n for n in got if n.endswith(("running_mean", "running_var"))]
    assert len(bn) > 100
    far, total = 0, 0
    for n, w in want.items():
        g = got[n].detach()
        if which == "gradients":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=2e-4 * float(w.abs().max()), err_msg=n)
        else:
            diff = (g - w).abs()
            assert float(diff.max()) <= 2 * LR * (1 + WD), n
            far += int((diff > 5e-5).sum())
            total += diff.numel()
    if which == "updated":
        print(f"updated entries beyond 5e-5: {far} of {total}")
        assert far <= 1e-4 * total
        for n in bn + ["feature_extractor.bn1.weight"]:
            assert not torch.equal(got[n].detach(), one_step["before"][n]), n


@pytest.mark.parametrize("size", [(32, 32), (20, 28), (64, 64), (96, 80)],
                         ids=["down2", "down_odd", "same", "up"])
def test_resize_target_matches_jax(size):
    """The loss's target resize: jax.image.resize bilinear with its default
    antialias, then > 0.5 (applied where input_sz is not the mask size)."""
    t = np.zeros((2, S, S, 1), np.float32)
    t[0, 10:41, 7:30] = 1.0
    t[1, 33:60, 20:51] = 1.0
    want = (jax.image.resize(jnp.asarray(t), (2, *size, 1), "bilinear") > 0.5)
    got = port_refine.resize_target(torch.from_numpy(t), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))


def _loss_inputs():
    rng = np.random.default_rng(5)
    return dict(
        pred=rng.normal(0.0, 1.0, (6, 17)).astype(np.float32),
        label=np.abs(rng.normal(0.0, 0.2, (6, 17))).astype(np.float32),
        ltrb_p=rng.uniform(0.05, 0.4, (5, 4)).astype(np.float32),
        ltrb_t=rng.uniform(0.05, 0.4, (5, 4)).astype(np.float32),
        weight=rng.uniform(0.0, 1.0, (5,)).astype(np.float32),
        out=rng.uniform(0.01, 0.5, (3, 6, 7, 4)).astype(np.float32),
        ind=np.asarray([8, 20, 40], np.int32),
        edge=np.asarray([0, 6, 41], np.int32),
        target=rng.uniform(0.1, 0.4, (3, 4)).astype(np.float32),
        logits=rng.normal(0.0, 3.0, (2, 9, 11, 1)).astype(np.float32),
        mask=(rng.random((2, 9, 11, 1)) > 0.6).astype(np.float32))


LOSSES = {
    "lb_hinge": lambda L, x: L.lb_hinge(x["pred"], x["label"]),
    "lb_hinge_clip": lambda L, x: L.lb_hinge(x["pred"], x["label"], threshold=0.1, clip=0.3),
    "iou_pred": lambda L, x: L.iou_pred_loss(x["ltrb_p"], x["ltrb_t"]),
    "iou_pred_weighted": lambda L, x: L.iou_pred_loss(x["ltrb_p"], x["ltrb_t"], x["weight"]),
    "iou_pred_zero_weight_sum": lambda L, x: L.iou_pred_loss(
        x["ltrb_p"], x["ltrb_t"], 0.0 * x["weight"], reduction="sum"),
    "gather_feat_hw": lambda L, x: L._gather_feat_hw(x["out"].reshape(3, 42, 4), x["ind"]),
    "reg_loss": lambda L, x: L.reg_loss(x["out"], x["ind"], x["target"]),
    "reg_loss_edge": lambda L, x: L.reg_loss(x["out"], x["edge"], x["target"], radius=2),
    "reg_loss_no_valid": lambda L, x: L.reg_loss(x["out"], x["ind"], 0.0 * x["target"]),
    "mask_losses": lambda L, x: L.mask_losses(x["logits"], x["mask"]),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_losses_match_jax(name):
    x = _loss_inputs()
    fn = LOSSES[name]
    if name == "mask_losses":
        want = jax.tree_util.tree_leaves(fn(jax_refine, {k: jnp.asarray(v) for k, v in x.items()}))
        got = jax.tree_util.tree_leaves(
            fn(port_refine, {k: torch.from_numpy(v) for k, v in x.items()}))
    else:
        want = [jax.jit(lambda a: fn(jax_losses, a))({k: jnp.asarray(v) for k, v in x.items()})]
        got = [fn(port_losses, {k: torch.from_numpy(v) for k, v in x.items()})]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_refine_main_trains_and_checkpoints(tmp_path):
    """The command line on the CPU: SyntheticVideo at input 64, one step of
    batch 2, a checkpoint that loads back strictly."""
    save = str(tmp_path / "refine")
    port_refine.main(["--datasets", "SyntheticVideo", "--epochs", "1", "--samples_per_epoch",
                      "2", "--batch_size", "2", "--input_sz", "64", "--save_dir", save,
                      "--device", "cpu"])
    path = os.path.join(save, "AlphaRefine_ep0001.pth.tar")
    net, _ = port_refine.build_refine_trainer(input_sz=64, device="cpu")[:2]
    assert load_variables(path, net, strict=True)["missing"] == []
