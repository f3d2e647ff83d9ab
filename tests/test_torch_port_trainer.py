"""The port's Trainer on the CPU: a tiny flagship (the geometry of
tests/test_torch_port_model.py at batch 2) trains 2 epochs x 2 steps on
SyntheticRGBT with a finite loss, and its CE keep rate per epoch equals
the JAX package's `Trainer._keep_rate` for the recipe's schedule
(CE_START_EPOCH 10, CE_WARM_EPOCH 40, keep 0.7, bucketised)."""
import types

import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.config import get_default_config as jax_default_config
from multi_modal_tracking_tpu.train.trainer import Trainer as JaxTrainer

from multi_modal_tracking_torch.config import get_default_config
from multi_modal_tracking_torch.train.trainer import Trainer
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RECIPE = "experiments/asymmetric_shared_ce/attention_lasher_newfusion_2layer.yaml"
TINY = dict(embed_dim=64, depth=4, num_heads=4, head_dim=64, ce_loc=(1, 3),
            ce_keep_ratio=(0.7, 0.7))


def _cfg(get=get_default_config):
    c = get("asymmetric_shared_ce")
    c.update_from_file(RECIPE)
    c.DATA.TRAIN.DATASETS_NAME = ["SyntheticRGBT"]
    c.DATA.VAL.DATASETS_NAME = []
    c.MODEL.BACKBONE.PRETRAINED = False
    c.MODEL.RGBT_PRETRAINED_PATH = ""
    c.DATA.SEARCH.SIZE, c.DATA.TEMPLATE.SIZE = 176, 112
    c.DATA.TRAIN.SAMPLE_PER_EPOCH = 4
    c.TRAIN.BATCH_SIZE = 2
    c.TRAIN.NUM_WORKER = 0
    return c


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tr = Trainer("asymmetric_shared_ce", _cfg(), save_dir=str(tmp_path_factory.mktemp("trainer")),
                 device="cpu", seed=0, spec_overrides=TINY, dtype=torch.float32)
    tr.train(max_epochs=2)
    return tr


def test_two_epochs_train_with_finite_loss(trained):
    assert trained.epoch == 2 and trained.steps_per_epoch == 2
    assert len(trained.history) == 2 and trained.optimizer.count == 4
    for m in trained.history:
        assert set(m) == {"Loss/total", "Loss/ciou", "Loss/l1", "IoU", "grad_norm"}
        assert all(np.isfinite(v) for v in m.values())
    assert trained.model.training


def test_keep_rate_schedule_matches_jax_trainer(trained):
    for spe in (2, 3750):
        jax_self = types.SimpleNamespace(cfg=_cfg(jax_default_config), steps_per_epoch=spe)
        trained.steps_per_epoch = spe
        for epoch in range(0, 61):
            assert trained._keep_rate(epoch) == JaxTrainer._keep_rate(jax_self, epoch), epoch
    trained.steps_per_epoch = 2
    assert trained._keep_rate(1) == 1.0 and trained._keep_rate(51) == 96 / 121   # ceil(0.7 * 121) = 85 -> 96


def test_non_finite_loss_raises(trained):
    trained.epoch = 1
    trained.optimizer.base_lr = float("nan")        # poisons the weights at step 1
    try:
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            trained.cycle_dataset()
    finally:
        trained.optimizer.base_lr = _cfg().TRAIN.LR
