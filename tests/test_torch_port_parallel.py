"""The port's data-parallel training, bootstrap and multi-device evaluation
on the CPU: two gloo processes (tests/torch_port_parallel_worker.py, one
spawn for every multi-process case of this file) at the tiny flagship
geometry of tests/test_torch_port_model.py (CORNER_UP head with trainable
BatchNorm, drop path and dropout 0), global batch 2, one sample a rank.
Torch runs on one intra-op thread here and in the workers: this model's
unclipped gradient norm moves by 1e-4 of itself between thread counts.

  * DP against the JAX package's `make_train_step(mesh=create_mesh(2))` on
    the same global batch and weights (the JAX model made deterministic:
    its fusion's dropout rate is fixed at 0.1 and its masks come from a JAX
    key), with the tolerances of
    tests/test_torch_port_train_step.py::test_step_gradients_match_jax:
    loss 1e-5 rel, grad_norm 1e-3 rel, the clipped gradients within that
    test's bounds of optax's clip of JAX's global-batch gradients, the
    head's BN running statistics 1e-5, and the parameters after the update
    within 2 learning rates + 1e-6 (an AdamW step moves a parameter by
    about its learning rate, and a near-zero gradient element whose sign
    differs gives two);
  * DP against the port's one-process step on the whole batch: metrics,
    buffers and gradients at atol 1e-6, also under ACCUM_ITER 2; the
    parameters after the update at 1e-6 + lr |dg| / eps in each element
    (the first AdamW step moves it by lr g / (|g| + eps), whose slope in g
    is at most 1 / eps: a gradient element near eps = 1e-8 turns a 1e-9
    difference into 1e-5 of the parameter);
  * synced BatchNorm on two halves against one BatchNorm on the whole
    batch: output, running statistics, input, weight and bias gradients;
  * per-rank loaders against the JAX `build_dataloaders` with its process
    count mocked (tests/test_distributed.py:42), and a global batch the
    world size does not divide raises;
  * the bootstrap: nothing configured is a no-op; the three flags form a
    group; torchrun's environment forms one;
  * `train.run` under two processes for one tiny epoch: rank 0 alone
    writes the config, the checkpoint and metrics.jsonl, each rank keeps
    its own dropout generator, the resume is exact on both ranks and the
    group is torn down; with the fail-safe restart on, a rank that fails
    raises instead of restarting alone, and the other rank raises too;
  * a graphed CUDA step over gloo raises;
  * `run_dataset(devices=["cpu", "cpu"], threads=2)` gives the sequential
    run's boxes.
"""
import copy
import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_modal_tracking_tpu.config import get_default_config as jax_default_config
from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as
from multi_modal_tracking_tpu.parallel.mesh import create_mesh, shard_batch
from multi_modal_tracking_tpu.train import builders as jax_builders
from multi_modal_tracking_tpu.train import optimizer as jax_opt
from multi_modal_tracking_tpu.train import train_step as jax_ts

from multi_modal_tracking_torch.config import get_default_config
from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.models.layers import BatchNorm2d
from multi_modal_tracking_torch.parallel import distributed as D
from multi_modal_tracking_torch.train import builders
from multi_modal_tracking_torch.train import optimizer as port_opt
from multi_modal_tracking_torch.train import train_step as port_ts
from multi_modal_tracking_torch.train.data.transforms import IMAGENET_STD
from multi_modal_tracking_torch.utils.convert import from_jax_variables
from tests.test_torch_port_model import GEOM, S_SZ, T_SZ, _randomise
from tests.test_torch_port_train_data import _cfg as _data_cfg
from tests.test_torch_port_train_step import RECIPE, _batch, _jax_grads, assert_grads_close
from tests.test_torch_port_trainer import TINY, _cfg as _trainer_cfg
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_port_parallel_worker.py")
SCRIPT = "asymmetric_shared_ce"
WORLD = 2
#: the variables torchrun and the launchers set: a test process must not
#: pass them on to its workers
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def spawn(case: str, workdir, world: int = WORLD, timeout: float = 240.0) -> list:
    """Run the worker's `case` on `world` gloo processes; their results.
    Fails fast: as soon as one rank exits with an error the others (which
    would wait on it in a rendezvous or a collective) are killed, and all
    are killed at `timeout` seconds."""
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.path.dirname(os.path.dirname(WORKER)))
    logs = [open(os.path.join(workdir, f"{case}_{r}.log"), "w+b") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, case, str(r), str(world), str(workdir)],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for f in logs:
        f.seek(0)
        text.append(f.read().decode(errors="replace"))
        f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (f"rank {r} exited {p.returncode} (killed: another rank "
                                   f"failed or {timeout:.0f} s passed):\n{text[r][-6000:]}")
    return [torch.load(os.path.join(workdir, f"{case}_{r}.pt"), weights_only=False)
            for r in range(world)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _recipe_cfgs():
    cfgs = []
    for get in (jax_default_config, get_default_config):
        c = get(SCRIPT)
        c.update_from_file(RECIPE)
        cfgs.append(c)
    return cfgs


def run_cfg():
    """The tiny Trainer config (tests/test_torch_port_trainer.py) with a val
    split of one batch a rank; global batch 2."""
    c = _trainer_cfg()
    c.DATA.VAL.DATASETS_NAME = ["SyntheticRGBT"]
    c.DATA.VAL.SAMPLE_PER_EPOCH = 2
    c.TRAIN.VAL_EPOCH_INTERVAL = 1
    return c


def tiny_inputs(state=None, **extra):
    """Randomised JAX variables of the tiny flagship, their port state dict
    (or `state`, and no JAX model), two global batches and the recipe
    configs."""
    jmodel = variables = None
    if state is None:
        jmodel = jax_as.MixFormerRGBT(spec=jax_as.RGBTSpec(**GEOM))
        tz = jnp.zeros((2, T_SZ, T_SZ, 3), jnp.float32)
        sz = jnp.zeros((2, S_SZ, S_SZ, 3), jnp.float32)
        variables = _randomise(jax.jit(jmodel.init)(jax.random.PRNGKey(0), tz, tz, sz), 0)
        state = from_jax_variables(variables)
    jcfg, pcfg = _recipe_cfgs()
    batches = [_batch(1), _batch(2)]
    inp = dict(geom=GEOM, state=state, cfg=pcfg, tiny=TINY,
               batches=[tuple(torch.from_numpy(x) for x in b) for b in batches],
               run_cfg=run_cfg(), **extra)
    return jmodel, variables, jcfg, batches, inp


def one_process_step(inp, accum):
    """The port's step on the whole batch in this process."""
    cfg = copy.deepcopy(inp["cfg"])
    cfg.TRAIN.ACCUM_ITER = accum
    model = port_as.MixFormerRGBT(port_as.RGBTSpec(**GEOM, drop_path_rate=0.0,
                                                   fusion_dropout=0.0))
    model.load_state_dict(inp["state"], strict=True)
    opt = port_opt.make_optimizer(cfg, model, steps_per_epoch=4)
    step = port_ts.make_train_step(model, opt, device="cpu")
    metrics = []
    for t, ot, s, gt in inp["batches"][:accum]:
        metrics.append({k: float(v) for k, v in
                        step({"t": t, "ot": ot, "s": s, "gt_xywh": gt},
                             ce_keep_rate=1.0).items()})
    names = [n for n, _ in model.named_parameters()]
    return dict(metrics=metrics,
                params={k: p.detach().clone() for k, p in model.named_parameters()},
                buffers={k: b.clone() for k, b in model.named_buffers()},
                grads=dict(zip(names, opt.grads)))


class _Deterministic:
    """The JAX model with its random layers off, for make_train_step."""

    def __init__(self, model):
        self.model = model

    def apply(self, *args, **kw):
        return self.model.apply(*args, **dict(kw, deterministic=True))


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("dp")
    torch.manual_seed(0)
    bn_x = torch.randn(4, 6, 5, 5) * 3.0 + 1.5
    bn_state = {"weight": torch.rand(6) + 0.5, "bias": torch.randn(6),
                "running_mean": torch.randn(6), "running_var": torch.rand(6) + 0.5,
                "num_batches_tracked": torch.tensor(0)}
    jmodel, variables, jcfg, batches, inp = tiny_inputs(
        bn_x=bn_x, bn_gy=torch.randn(4, 6, 5, 5), bn_state=bn_state, port=free_port())
    torch.save(inp, workdir / "inputs.pt")
    ranks = spawn("dp", workdir)
    return dict(ranks=ranks, inp=inp, jmodel=jmodel, variables=variables, jcfg=jcfg,
                batches=batches, workdir=workdir)


def _assert_state_close(got, want, atol, what):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].double().numpy(), want[k].double().numpy(),
                                   atol=atol, rtol=0, err_msg=f"{what} {k}")


def test_dp_step_matches_jax_mesh_step(dp):
    jmodel, variables, jcfg, batches = dp["jmodel"], dp["variables"], dp["jcfg"], dp["batches"]
    tx = jax_opt.make_optimizer(jcfg, variables["params"], steps_per_epoch=4)
    mesh = create_mesh(2)
    step = jax_ts.make_train_step(_Deterministic(jmodel), tx, mesh=mesh)
    t, ot, s, gt = batches[0]
    B = gt.shape[0]
    batch = dict(template_v=t[:B], template_i=t[B:], online_template_v=ot[:B],
                 online_template_i=ot[B:], search_v=s[:B], search_i=s[B:], gt_xywh=gt)
    state, metrics = step(jax_ts.TrainState.create(variables, tx), shard_batch(batch, mesh),
                          jax.random.PRNGKey(0), ce_keep_rate=1.0)
    want = {k: float(v) for k, v in metrics.items()}
    grads, _, _ = _jax_grads(jmodel, variables, batches[0], 1.0)
    clipped, _ = optax.clip_by_global_norm(jcfg.TRAIN.GRAD_CLIP_NORM).update(grads, None)
    want_grads = from_jax_variables({"params": jax.device_get(clipped)})
    want_params = from_jax_variables({"params": jax.device_get(state.params)})
    want_stats = from_jax_variables({"batch_stats": jax.device_get(state.batch_stats)})
    lr = max(jcfg.TRAIN.LR, jcfg.TRAIN.LR * jcfg.TRAIN.BACKBONE_MULTIPLIER)

    model = port_as.MixFormerRGBT(port_as.RGBTSpec(**GEOM))
    for r in dp["ranks"]:
        got = r["dp"]
        for k in want:
            np.testing.assert_allclose(got["metrics"][0][k], want[k],
                                       rtol=1e-3 if k == "grad_norm" else 1e-5, err_msg=k)
        for name, p in model.named_parameters():
            p.grad = got["grads"][name]
        assert_grads_close(model, want_grads, float(optax.global_norm(clipped)))
        _assert_state_close(got["params"], want_params, 2 * lr + 1e-6, "parameter")
        for k, w in want_stats.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(got["buffers"][k].numpy(), w.numpy(), atol=1e-5,
                                           rtol=1e-5, err_msg=k)
    assert any("box_head" in k and k.endswith("running_var") for k in want_stats)


@pytest.mark.parametrize("accum", [1, 2], ids=["accum_1", "accum_2"])
def test_dp_step_matches_one_process_step(dp, accum):
    want = one_process_step(dp["inp"], accum)
    LR = dp["inp"]["cfg"].TRAIN.LR
    key = "dp" if accum == 1 else "dp_accum"
    for r in dp["ranks"]:
        got = r[key]
        assert len(got["metrics"]) == accum
        for g, w in zip(got["metrics"], want["metrics"]):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=1e-6, err_msg=k)
        for what in ("buffers", "grads"):
            _assert_state_close(got[what], want[what], 1e-6, what)
        lr = max(LR * m for m in (1.0, dp["inp"]["cfg"].TRAIN.BACKBONE_MULTIPLIER))
        for k, w in want["params"].items():
            tol = 1e-6 + lr * (got["grads"][k] - want["grads"][k]).abs() / port_opt.EPS
            assert bool(((got["params"][k] - w).abs() <= tol).all()), k
    # the ranks hold the same state
    a, b = (r[key]["params"] for r in dp["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_synced_batchnorm_equals_whole_batch(dp):
    inp = dp["inp"]
    x = inp["bn_x"].clone().requires_grad_(True)
    bn = BatchNorm2d(x.shape[1])
    bn.load_state_dict(inp["bn_state"])
    bn.train()
    y = bn(x)
    (y * inp["bn_gy"]).sum().backward()
    ranks = [r["bn"] for r in dp["ranks"]]
    close = dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(torch.cat([r["y"] for r in ranks]).numpy(), y.detach().numpy(),
                               **close)
    np.testing.assert_allclose(torch.cat([r["x_grad"] for r in ranks]).numpy(),
                               x.grad.numpy(), **close)
    for r in ranks:
        np.testing.assert_allclose(r["running_mean"].numpy(), bn.running_mean.numpy(), **close)
        np.testing.assert_allclose(r["running_var"].numpy(), bn.running_var.numpy(), **close)
    # the parameter gradients are each rank's part: the DP reduction sums them
    np.testing.assert_allclose(sum(r["weight_grad"] for r in ranks).numpy(),
                               bn.weight.grad.numpy(), **close)
    np.testing.assert_allclose(sum(r["bias_grad"] for r in ranks).numpy(),
                               bn.bias.grad.numpy(), **close)


def test_per_rank_loaders_match_jax(monkeypatch):
    cfgs = []
    for get in (jax_default_config, get_default_config):
        c = _data_cfg(get)
        c.DATA.TRAIN.SAMPLE_PER_EPOCH = 8
        c.TRAIN.BATCH_SIZE = 8
        cfgs.append(c)
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    monkeypatch.setattr(builders, "world_size", lambda: 4)
    jt, _ = jax_builders.build_dataloaders(cfgs[0], seed=5)
    pt, _ = builders.build_dataloaders(cfgs[1], seed=5)
    assert (pt.batch_size, pt.sampler.samples_per_epoch, len(pt)) == \
        (jt.batch_size, jt.sampler.samples_per_epoch, len(jt)) == (2, 2, 1)
    # the same samples (tests/test_torch_port_lifecycle.py's tolerances)
    j, p = next(iter(jt)), next(iter(pt))
    assert j.keys() == p.keys()
    for k in j:
        assert j[k].shape == p[k].shape, k
        if "anno" in k:
            np.testing.assert_allclose(p[k], j[k], atol=1e-6, rtol=0, err_msg=k)
        elif "images" in k:
            np.testing.assert_allclose(p[k] * IMAGENET_STD, j[k] * IMAGENET_STD, atol=1 / 255,
                                       rtol=0, err_msg=k)
    cfgs[1].TRAIN.BATCH_SIZE = 6
    with pytest.raises(ValueError, match="not divisible by the 4 processes"):
        builders.build_dataloaders(cfgs[1], seed=5)


def test_bootstrap_noop_and_gates(monkeypatch):
    for k in _LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert D.initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert (D.world_size(), D.rank(), D.is_main_process(), D.process_seed(42)) == \
        (1, 0, True, 42)
    with pytest.raises(ValueError, match="go together"):
        D.initialize_distributed("localhost:1", None, 0, device="cpu")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="lacks"):
        D.initialize_distributed(device="cpu")


def test_bootstrap_forms_groups(dp):
    for rank, r in enumerate(dp["ranks"]):
        assert r["torchrun"] == dict(formed=True, world=2, rank=rank, sum=3.0)
        assert r["generator_seed"] == 10 + rank and r["main"] == (rank == 0)


def test_train_run_two_processes_and_exact_resume(dp):
    save = dp["workdir"] / "run"
    ckpts = sorted(os.listdir(save / "checkpoints" / SCRIPT))
    assert ckpts == ["MixFormerRGBT_ep0001.pth.tar"]
    rows = [json.loads(ln) for ln in open(save / "logs" / SCRIPT / "metrics.jsonl")]
    # one train row and one val row of epoch 1, written by rank 0 alone
    assert [(r["loader"], r["epoch"]) for r in rows] == [("train", 1), ("val", 1)]
    assert os.path.isfile(save / f"{SCRIPT}_default.yaml")
    for r in dp["ranks"]:
        assert r["run"]["same"] == dict(epoch=(1, 1), model=True, optimizer=True,
                                        generator=True)
        assert r["run"]["initialized_after"] is False
    g0, g1 = (r["run"]["generator"] for r in dp["ranks"])
    assert not torch.equal(g0, g1)
    state = torch.load(save / "checkpoints" / SCRIPT / ckpts[0], weights_only=True)
    assert state["world_size"] == 2
    assert [torch.equal(a, b) for a, b in zip(state["generators"], (g0, g1))] == [True, True]


def test_fail_safe_raises_on_a_failing_rank(dp):
    """train.run's fail-safe restart (on by default) under two processes:
    rank 1 fails as its first epoch begins and raises at once instead of
    restarting alone (which would pair its collectives with rank 0's later
    steps); rank 0's collective then fails and it raises too, no rank
    hangs, and each tears its group down."""
    r0, r1 = (r["fail"] for r in dp["ranks"])
    assert r1["error"] == "RuntimeError: injected failure on rank 1"
    assert r1["began"] == [1]
    assert r0["error"] is not None and r0["began"] == [1]
    assert not r0["initialized_after"] and not r1["initialized_after"]


def test_capture_records_only_captured_launches(monkeypatch):
    """A graph capture's launch counts are the launches its capture took
    (ops/_build.py record_capture: made while the launching thread's stream
    captures, as the autograd engine's thread does in a captured backward),
    whatever another thread (an eval worker of run_dataset(threads=...))
    launches eagerly meanwhile; the process's counts hold the eager
    launches alone until a replay adds the record."""
    from multi_modal_tracking_torch.ops import _build
    from multi_modal_tracking_torch.tracking import graphs

    def wrapper():
        pass
    wrapper.launches, wrapper.launches_by_kernel = 0, {"a": 0, "b": 0}
    # a stand-in for the stream state: device "capture" is capturing
    monkeypatch.setattr(_build, "_capturing", lambda device: device == "capture")
    go, done = threading.Event(), threading.Event()

    def eager_worker():
        go.wait()
        for _ in range(1000):
            _build.count_launch(wrapper, "eager", ("b",))
        done.set()

    def backward_thread():      # the autograd engine's, on the capture stream
        for _ in range(200):
            _build.count_launch(wrapper, "capture", ("a",))
    t = threading.Thread(target=eager_worker)
    t.start()
    with _build.record_capture() as counts:
        go.set()
        for _ in range(300):
            _build.count_launch(wrapper, "capture", ("a",))
        b = threading.Thread(target=backward_thread)
        b.start()
        b.join()
        done.wait()
        with pytest.raises(RuntimeError, match="another capture"):
            _build.record_capture().__enter__()
    t.join()
    assert counts == {"wrapper": 500, "wrapper/a": 500}
    assert wrapper.launches == 1000 and wrapper.launches_by_kernel == {"a": 0, "b": 1000}
    monkeypatch.setattr(graphs, "_counters", lambda: (wrapper,))
    graphs.add_counts(counts)                       # a replay
    assert wrapper.launches == 1500 and wrapper.launches_by_kernel == {"a": 500, "b": 1000}
    _build.count_launch(wrapper, "capture")         # a capture nothing records
    assert wrapper.launches == 1501


def test_graphed_cuda_step_over_gloo_raises(monkeypatch):
    class Gloo:
        capturable, backend = False, "gloo"
    monkeypatch.setattr(port_ts, "resolve_device", lambda d: torch.device("cuda"))
    with pytest.raises(ValueError, match="pass graphs=False"):
        port_ts.make_train_step(torch.nn.Linear(2, 2), None, dp=Gloo())


def test_run_dataset_over_devices_equals_sequential(dp, tmp_path):
    """Two workers pinned to two (CPU) devices, each building its cached
    tracker of the tiny flagship there, write the sequential run's boxes bit
    for bit; a tracker built elsewhere raises."""
    from multi_modal_tracking_torch.eval import datasets, running
    from multi_modal_tracking_torch.tracking.tracker import RGBTCachedTracker
    from tests.test_torch_port_eval import KW

    seqs = datasets.get_dataset("synthetic_rgbt", n_sequences=3, n_frames=6)
    made = []

    def factory(device=torch.device("cpu")):
        model = port_as.MixFormerRGBT(port_as.RGBTSpec(**GEOM)).eval()
        model.load_state_dict(dp["inp"]["state"], strict=True)
        made.append(device)
        return RGBTCachedTracker(model, device=device, **KW)
    seq_stats = running.run_dataset(seqs, factory(), str(tmp_path / "seq"))
    made.clear()
    par_stats = running.run_dataset(seqs, None, str(tmp_path / "par"), threads=2,
                                    tracker_factory=factory, devices=["cpu", "cpu"])
    assert [s["seq"] for s in par_stats] == [s["seq"] for s in seq_stats]
    for a, b in zip(par_stats, seq_stats):
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
    assert 1 <= len(made) <= 2 and all(d == torch.device("cpu") for d in made)

    class Elsewhere:
        device = torch.device("meta")
    with pytest.raises(ValueError, match="got a tracker on meta"):
        running.run_dataset(seqs, None, str(tmp_path / "bad"), threads=1,
                            tracker_factory=lambda d: Elsewhere(), devices=["cpu"])
    with pytest.raises(ValueError, match="threads > 0"):
        running.run_dataset(seqs, None, str(tmp_path / "bad"), devices=["cpu"])
