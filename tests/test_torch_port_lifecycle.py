"""The port's training lifecycle on the CPU, at the tiny geometry of
tests/test_torch_port_trainer.py (width 64, depth 4, CE at 1/3, search 176,
template 112, batch 2), against the JAX package where it has a counterpart.

  * save and resume are exact: a fresh Trainer's load_checkpoint equals the
    saved one bit for bit (weights, buffers, AdamW state, count, epoch, the
    dropout / drop-path generator), and an epoch after the resume equals
    the same epoch of the uninterrupted trainer bit for bit;
  * the fail-safe restart finishes, from the latest checkpoint or, before
    the first one exists, from the current weights (tests/test_trainer.py);
  * metrics.jsonl rows have the JAX StatsTracker's keys and values for the
    same per-step metrics;
  * a port-saved epoch checkpoint loads strictly into the JAX model, and the
    JAX tracker on it follows the port tracker (create_tracker with the
    checkpoint) within 0.02 px, the tolerance of
    tests/test_torch_port_tracker.py;
  * ACCUM_ITER: the applied-update schedule of tests/test_trainer.py on the
    port's optimizer; one k=2 group on the tiny flagship against optax
    MultiSteps (the mean gradient within the gradient bounds of
    tests/test_torch_port_train_step.py, grad_norm per micro-batch 1e-3
    rel; the optimizer on identical gradients within that file's 1e-6);
  * the val step against JAX's make_eval_step (metrics 1e-4 rel: eval-mode
    boxes agree to ~2e-6 here, test_torch_port_model.py) and the first val
    batch against JAX's val loader (the tolerances of
    tests/test_torch_port_train_data.py);
  * the training CLI's flags map onto the config and the Trainer, the
    multi-process ones form (and tear down) the process group.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_modal_tracking_tpu.config import get_default_config as jax_default_config
from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as
from multi_modal_tracking_tpu.tracking import tracker as jax_tracker
from multi_modal_tracking_tpu.train import builders as jax_builders
from multi_modal_tracking_tpu.train import optimizer as jax_opt
from multi_modal_tracking_tpu.train import train_step as jax_ts
from multi_modal_tracking_tpu.train.stats import StatsTracker as JaxStatsTracker
from multi_modal_tracking_tpu.utils import checkpoint as jax_ckpt

from multi_modal_tracking_torch.config import get_default_config
from multi_modal_tracking_torch.eval.evaltracker import create_tracker
from multi_modal_tracking_torch.eval.params import get_parameters, update_interval_for
from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.train import builders
from multi_modal_tracking_torch.train import optimizer as port_opt
from multi_modal_tracking_torch.train import run
from multi_modal_tracking_torch.train import train_step as port_ts
from multi_modal_tracking_torch.train.trainer import Trainer
from multi_modal_tracking_torch.utils import checkpoint as port_ckpt
from multi_modal_tracking_torch.utils.convert import from_jax_variables
from tests.test_torch_port_isolation import _tiny_builder
from tests.test_torch_port_model import GEOM, S_SZ, T_SZ, _randomise
from tests.test_torch_port_tracker import _frames
from tests.test_torch_port_train_data import _cfg as _data_cfg
from tests.test_torch_port_train_step import _batch, _jax_grads, assert_grads_close
from tests.test_torch_port_trainer import RECIPE, TINY, _cfg
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SCRIPT = "asymmetric_shared_ce"


def _life_cfg(val=True, get=get_default_config):
    c = _cfg(get)
    if val:
        c.DATA.VAL.DATASETS_NAME = ["SyntheticRGBT"]
        c.DATA.VAL.SAMPLE_PER_EPOCH = 2
        c.TRAIN.VAL_EPOCH_INTERVAL = 1
    return c


def _trainer(save_dir, cfg=None, seed=0):
    return Trainer(SCRIPT, cfg or _life_cfg(), save_dir=str(save_dir), device="cpu", seed=seed,
                   spec_overrides=TINY, dtype=torch.float32)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """2 epochs x 2 steps with a val batch after each epoch."""
    save_dir = tmp_path_factory.mktemp("lifecycle")
    tr = _trainer(save_dir)
    tr.train(max_epochs=2)
    return tr, save_dir


def _assert_same_trainer(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert (oa["count"], oa["mini_step"]) == (ob["count"], ob["mini_step"])
    assert oa["adamw"]["state"].keys() == ob["adamw"]["state"].keys()
    for i, st in oa["adamw"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["adamw"]["state"][i][k]), (i, k)
    assert a.epoch == b.epoch
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# ------------------------------------------------------------ save/resume
def test_save_and_resume_are_exact(trained):
    tr, save_dir = trained
    files = sorted(os.listdir(tr.ckpt_dir))
    assert files == ["MixFormerRGBT_ep0001.pth.tar", "MixFormerRGBT_ep0002.pth.tar"]
    state = port_ckpt.load_checkpoint(os.path.join(tr.ckpt_dir, files[-1]))
    assert set(state) == {"epoch", "net_type", "net", "optimizer", "generator"}
    assert state["net_type"] == "MixFormerRGBT" and state["optimizer"]["count"] == 4
    fresh = _trainer(save_dir, seed=5)
    assert fresh.load_checkpoint()
    _assert_same_trainer(tr, fresh)


def test_epoch_after_resume_equals_uninterrupted(tmp_path):
    """Drop path and dropout stay on: the generator state must resume too.
    The seed is the run's (it also seeds the data), as with --resume. One
    CPU thread: PyTorch's multithreaded CPU backward is not bit-reproducible
    from run to run (two fresh trainers differ in the last bits after one
    epoch), one thread is."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole = _trainer(tmp_path)
        whole.train(max_epochs=1)
        resumed = _trainer(tmp_path)
        assert resumed.load_checkpoint() and resumed.epoch == 1
        whole.train(max_epochs=2)
        resumed.train(max_epochs=2)
    finally:
        torch.set_num_threads(threads)
    _assert_same_trainer(whole, resumed)
    assert whole.history == resumed.history


@pytest.mark.parametrize("fail_at", [1, 2], ids=["before_any_checkpoint", "after_epoch_1"])
def test_fail_safe_restart(tmp_path, fail_at):
    tr = _trainer(tmp_path, _life_cfg(val=False))
    calls = {"n": 0}
    orig = tr.cycle_dataset

    def flaky(loader=None, train=True):
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise RuntimeError("injected failure")
        return orig(loader, train)

    tr.cycle_dataset = flaky
    tr.train(max_epochs=2, fail_safe=True)
    assert tr.epoch == 2 and calls["n"] == 3
    assert tr.optimizer.count == 4
    assert sorted(os.listdir(tr.ckpt_dir)) == ["MixFormerRGBT_ep0001.pth.tar",
                                               "MixFormerRGBT_ep0002.pth.tar"]
    tr.cycle_dataset = lambda loader=None, train=True: 1 / 0
    with pytest.raises(ZeroDivisionError):
        tr.train(max_epochs=3, fail_safe=True, max_failures=2)
    assert tr.epoch == 2


def test_metrics_jsonl_has_jax_keys(trained, tmp_path):
    tr, save_dir = trained
    with open(os.path.join(save_dir, "logs", SCRIPT, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [(r["loader"], r["epoch"]) for r in rows] == [("train", 1), ("val", 1),
                                                         ("train", 2), ("val", 2)]
    want = JaxStatsTracker(None)
    for m in tr.history:           # the last cycle: epoch 2's val batch
        want.update(m, 2)
    assert rows[-1] == json.loads(json.dumps(want.log_epoch("val", 2)))
    jax_keys = set(jax_ts.box_losses(jnp.full((2, 1, 4), 0.5), jnp.full((2, 4), 0.3), 2.0,
                                     5.0)[1])
    assert set(rows[0]) == {"loader", "epoch", "grad_norm"} | jax_keys
    assert set(rows[1]) == {"loader", "epoch"} | jax_keys


# ---------------------------------------------------- checkpoint -> JAX
def test_port_checkpoint_loads_strictly_into_jax_and_trackers_agree(trained, monkeypatch):
    tr, _ = trained
    path = port_ckpt.latest_checkpoint(tr.ckpt_dir, tr.net_name)
    jmodel = jax_as.MixFormerRGBT(spec=jax_as.RGBTSpec(drop_path_rate=0.0, **GEOM))
    tz = jnp.zeros((2, T_SZ, T_SZ, 3), jnp.float32)
    sz = jnp.zeros((2, S_SZ, S_SZ, 3), jnp.float32)
    variables = jax_ckpt.load_variables(path, jax.jit(jmodel.init)(jax.random.PRNGKey(0), tz, tz,
                                                                   sz), strict=True)

    params = get_parameters(SCRIPT, "attention_lasher_newfusion_2layer")
    params.template_size, params.search_size = T_SZ, S_SZ
    params.template_factor, params.search_factor = 2.0, 4.5
    params.checkpoint = path
    _tiny_builder(monkeypatch, GEOM)
    port = create_tracker(params, device="cpu", seed=3, dtype=torch.float32)
    jt = jax_tracker.RGBTCachedTrackerJit(
        model=jmodel, variables=variables, template_factor=2.0, template_size=T_SZ,
        search_factor=4.5, search_size=S_SZ, update_interval=update_interval_for(params.cfg, ""))
    fv, fi, init_box = _frames(4)
    jt.initialize([fv[0], fi[0]], {"init_bbox": init_box})
    port.initialize([fv[0], fi[0]], {"init_bbox": init_box})
    want = np.asarray([jt.track([fv[t], fi[t]])["target_bbox"] for t in range(1, len(fv))])
    got = np.asarray([port.track([fv[t], fi[t]])["target_bbox"] for t in range(1, len(fv))])
    np.testing.assert_allclose(got, want, atol=0.02, rtol=0)


# ----------------------------------------------------------- accumulation
def _sched_cfgs():
    cfgs = []
    for get in (jax_default_config, get_default_config):
        c = get(SCRIPT)
        c.TRAIN.RGBT_TRACK_SHARED = False          # the default regime: box_head in "main"
        c.TRAIN.ACCUM_ITER = 3
        c.TRAIN.SCHEDULER.TYPE = "step"
        c.TRAIN.LR_DROP_EPOCH = 1
        cfgs.append(c)
    return cfgs


def test_lr_schedule_counts_applied_updates_under_accumulation():
    """tests/test_trainer.py's schedule test on the port's optimizer, and
    the same trajectory as optax MultiSteps (1e-6)."""
    jcfg, pcfg = _sched_cfgs()
    steps_per_epoch = 6                # loader batches -> 2 updates per epoch
    model = torch.nn.Module()
    model.box_head = torch.nn.Module()
    model.box_head.w = torch.nn.Parameter(torch.ones(4))
    opt = port_opt.make_optimizer(pcfg, model, steps_per_epoch=steps_per_epoch)
    params = {"box_head": {"w": jnp.ones((4,))}}
    tx = jax_opt.make_optimizer(jcfg, params, steps_per_epoch=steps_per_epoch)
    state = tx.init(params)
    g = {"box_head": {"w": jnp.full((4,), 0.5)}}
    deltas = []
    for _ in range(2 * steps_per_epoch):
        before = model.box_head.w.detach().clone()
        model.box_head.w.grad = torch.full((4,), 0.5)
        opt.update()
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
        np.testing.assert_allclose(model.box_head.w.detach().numpy(),
                                   np.asarray(params["box_head"]["w"]), atol=1e-6, rtol=1e-6)
        d = float((model.box_head.w.detach() - before).abs().max())
        if d > 0:
            deltas.append(d)
    assert len(deltas) == 4 and opt.count == 4
    assert deltas[1] == pytest.approx(deltas[0], rel=0.2)
    assert deltas[2] < 0.3 * deltas[0]
    assert deltas[3] < 0.3 * deltas[0]


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_as.MixFormerRGBT(spec=jax_as.RGBTSpec(**GEOM))
    tz = jnp.zeros((2, T_SZ, T_SZ, 3), jnp.float32)
    sz = jnp.zeros((2, S_SZ, S_SZ, 3), jnp.float32)
    variables = _randomise(jax.jit(jmodel.init)(jax.random.PRNGKey(0), tz, tz, sz), 0)
    pmodel = port_as.MixFormerRGBT(port_as.RGBTSpec(**GEOM, drop_path_rate=0.0,
                                                    fusion_dropout=0.0))
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, variables, pmodel


def _accum_cfgs():
    cfgs = []
    for get in (jax_default_config, get_default_config):
        c = get(SCRIPT)
        c.update_from_file(RECIPE)
        c.TRAIN.ACCUM_ITER = 2
        cfgs.append(c)
    return cfgs


def _inputs(batch):
    t, ot, s, gt = (torch.from_numpy(x) for x in batch)
    return {"t": t, "ot": ot, "s": s, "gt_xywh": gt}


def test_accumulation_group_matches_multisteps(pair):
    """Two micro-batches through the port's train step at ACCUM_ITER 2
    against JAX's gradients of the same batches: nothing moves after the
    first; the gradient of the update (the clipped mean) is within the
    train-step test's bounds of optax's clip of the mean."""
    jmodel, variables, pmodel = pair
    _, pcfg = _accum_cfgs()
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    opt = port_opt.make_optimizer(pcfg, pmodel, steps_per_epoch=4)
    step = port_ts.make_train_step(pmodel, opt, device="cpu")
    batches = [_batch(1), _batch(2)]
    before = {k: v.clone() for k, v in pmodel.named_parameters()}
    norms = [float(step(_inputs(batches[0]), ce_keep_rate=1.0)["grad_norm"])]
    assert all(torch.equal(p, before[k]) for k, p in pmodel.named_parameters())
    assert opt.count == 0 and opt.mini_step == 1
    norms.append(float(step(_inputs(batches[1]), ce_keep_rate=1.0)["grad_norm"]))
    assert opt.count == 1 and opt.mini_step == 0
    assert any(not torch.equal(p, before[k]) for k, p in pmodel.named_parameters())

    grads = [_jax_grads(jmodel, variables, b, 1.0) for b in batches]
    for got, (_, metrics, _) in zip(norms, grads):
        assert got == pytest.approx(metrics["grad_norm"], rel=1e-3)
    mean = jax.tree.map(lambda a, b: a + (b - a) / 2, grads[0][0], grads[1][0])
    clipped, _ = optax.clip_by_global_norm(0.1).update(mean, None)
    assert_grads_close(pmodel, from_jax_variables({"params": jax.device_get(clipped)}),
                       float(optax.global_norm(clipped)))


def test_accumulation_optimizer_matches_multisteps(pair):
    """Identical gradients into the port's optimizer and the JAX package's
    make_optimizer (optax MultiSteps around clip + AdamW) at ACCUM_ITER 2:
    two groups of two, the second with the LR dropped (LR_DROP_EPOCH 1,
    2 updates per epoch of 4 batches)."""
    jmodel, variables, pmodel = pair
    jcfg, pcfg = _accum_cfgs()
    for c in (jcfg, pcfg):
        c.TRAIN.LR_DROP_EPOCH = 1
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    opt = port_opt.make_optimizer(pcfg, pmodel, steps_per_epoch=2)
    params = variables["params"]
    tx = jax_opt.make_optimizer(jcfg, params, steps_per_epoch=2)
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    rng = np.random.default_rng(8)
    for i, scale in enumerate((1e-2, 3e-2, 1e-5, 2e-2)):
        g = jax.tree.map(lambda a: (scale * rng.standard_normal(np.shape(a))).astype(np.float32),
                         params)
        pg = from_jax_variables({"params": g})
        for name, p in pmodel.named_parameters():
            p.grad = pg[name].clone()
        norm = opt.update()
        assert float(norm) == pytest.approx(float(optax.global_norm(g)), rel=1e-5)
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
        assert opt.count == (i + 1) // 2
    want = from_jax_variables({"params": jax.device_get(params)})
    for name, p in pmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=name)


# -------------------------------------------------------------------- val
def test_eval_step_matches_jax(pair):
    jmodel, variables, pmodel = pair
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    t, ot, s, gt = _batch(3)
    batch = {"template_v": t[:2], "template_i": t[2:], "online_template_v": ot[:2],
             "online_template_i": ot[2:], "search_v": s[:2], "search_i": s[2:], "gt_xywh": gt}
    want = jax_ts.make_eval_step(jmodel)(variables["params"], variables["batch_stats"], batch)
    pmodel.train()
    got = port_ts.make_eval_step(pmodel, device="cpu")(batch)
    assert not pmodel.training
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_first_val_batch_equals_jax():
    from multi_modal_tracking_torch.train.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    cfgs = []
    for get in (jax_default_config, get_default_config):
        c = _data_cfg(get)
        c.DATA.VAL.DATASETS_NAME = ["SyntheticRGBT"]
        c.DATA.VAL.SAMPLE_PER_EPOCH = 4
        cfgs.append(c)
    _, jv = jax_builders.build_dataloaders(cfgs[0], seed=3)
    _, pv = builders.build_dataloaders(cfgs[1], seed=3)
    assert (pv.name, pv.training, pv.epoch_interval, len(pv)) == \
        (jv.name, jv.training, jv.epoch_interval, len(jv))
    j, p = next(iter(jv)), next(iter(pv))
    assert j.keys() == p.keys()
    for k in j:
        assert j[k].shape == p[k].shape and j[k].dtype == p[k].dtype, k
        if "anno" in k:
            np.testing.assert_allclose(p[k], j[k], atol=1e-6, rtol=0, err_msg=k)
        elif "images" in k:
            unnorm = lambda x: x * IMAGENET_STD + IMAGENET_MEAN   # noqa: E731
            np.testing.assert_allclose(unnorm(p[k]), unnorm(j[k]), atol=1 / 255, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)


def test_unbuildable_val_split_is_disabled_like_jax(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("MMT_LOCAL_PATHS", str(tmp_path / "none.json"))
    cfg = _data_cfg(get_default_config)
    cfg.DATA.VAL.DATASETS_NAME = ["LasHeR"]
    assert builders.build_dataloaders(cfg)[1] is None
    out = capsys.readouterr().out
    # LasHeR is ported; with no path configured it raises as the JAX one does
    assert "[build_dataloaders] val loader disabled: RuntimeError(" in out
    assert "lasher_dir" in out
    cfg.DATA.VAL.DATASETS_NAME = ["NoSuchSet"]
    with pytest.raises(ValueError, match="Unknown dataset name"):
        builders.build_dataloaders(cfg)


# -------------------------------------------------------------------- CLI
class _FakeTrainer:
    made = []

    def __init__(self, script, cfg, save_dir="output", device="cuda", seed=42, **kw):
        self.args = dict(script=script, cfg=cfg, save_dir=save_dir, device=device, seed=seed, **kw)
        self.net_name, self.steps_per_epoch = "MixFormerRGBT", 1
        self.optimizer = type("O", (), {"groups": {}})()
        _FakeTrainer.made.append(self)

    def train(self, **kw):
        self.train_kw = kw


def test_cli_flags_map_onto_cfg_and_trainer(tmp_path, monkeypatch):
    import yaml
    import multi_modal_tracking_torch.train.trainer as trainer_mod
    monkeypatch.setattr(trainer_mod, "Trainer", _FakeTrainer)
    _FakeTrainer.made.clear()
    run.main(["--script", SCRIPT, "--config", "attention_lasher_newfusion_2layer",
              "--save_dir", str(tmp_path), "--seed", "3", "--epochs", "7", "--batch", "4",
              "--resume", "--no_fail_safe", "--device", "cpu"])
    tr, = _FakeTrainer.made
    cfg = tr.args["cfg"]
    assert (cfg.TRAIN.EPOCH, cfg.TRAIN.BATCH_SIZE, cfg.MODEL.FUSION_LAYERS) == (7, 4, 2)
    assert {k: tr.args[k] for k in ("script", "save_dir", "device", "seed")} == \
        dict(script=SCRIPT, save_dir=str(tmp_path), device="cpu", seed=3)
    assert tr.train_kw == dict(load_latest=True, fail_safe=False)
    with open(tmp_path / f"{SCRIPT}_attention_lasher_newfusion_2layer.yaml") as f:
        assert yaml.safe_load(f) == cfg.to_dict()
    run.main(["--script", SCRIPT, "--save_dir", str(tmp_path)])
    tr = _FakeTrainer.made[-1]
    assert (tr.args["device"], tr.args["seed"]) == ("cuda", 42)
    assert tr.train_kw == dict(load_latest=False, fail_safe=True)
    assert os.path.isfile(tmp_path / f"{SCRIPT}_default.yaml")


@pytest.mark.parametrize("flag", [["--fsdp"], ["--remat"], ["--coordinator", "h:1"],
                                  ["--num_processes", "2"], ["--process_id", "0"]],
                         ids=lambda f: f[0])
def test_cli_unported_flags_raise(flag, tmp_path, monkeypatch):
    """The flags of tracking/train.py that the port took over: --fsdp and
    --remat set their config keys (FSDP runs eager); the multi-process
    flags form the group from the three together (here a gloo group of
    one process on a file store) and tear it down at exit, and one of them
    alone raises before anything is written."""
    import multi_modal_tracking_torch.train.trainer as trainer_mod
    monkeypatch.setattr(trainer_mod, "Trainer", _FakeTrainer)
    _FakeTrainer.made.clear()
    base = ["--script", SCRIPT, "--save_dir", str(tmp_path), "--device", "cpu"]
    if flag[0] in ("--fsdp", "--remat"):
        run.main(base + flag)
        tr, = _FakeTrainer.made
        key = flag[0][2:].upper()
        assert tr.args["cfg"].TRAIN[key] is True
        assert tr.args["graphs"] is (key != "FSDP")
        return
    with pytest.raises(ValueError, match="go together"):
        run.main(base + flag)
    assert not os.listdir(tmp_path)
    triple = {"--coordinator": f"file://{tmp_path}/store", "--num_processes": "1",
              "--process_id": "0"}
    seen = []
    monkeypatch.setattr(_FakeTrainer, "train", lambda self, **kw: seen.append(
        (torch.distributed.get_world_size(), torch.distributed.get_rank())))
    run.main(base + [x for k, v in triple.items() for x in (k, v)])
    assert seen == [(1, 0)] and not torch.distributed.is_initialized()
    assert _FakeTrainer.made[-1].args["device"] == "cpu"
