"""One rank of the port's multi-process CPU tests (gloo): run as

    python tests/torch_port_parallel_worker.py CASE RANK WORLD WORKDIR

by tests/test_torch_port_parallel.py and tests/test_torch_port_fsdp.py,
which write `WORKDIR/inputs.pt` first and read `WORKDIR/<case>_<rank>.pt`
after. Each case forms its groups through `file://` stores under WORKDIR
(no port shared between test processes), except the torchrun bootstrap,
which needs MASTER_PORT (WORKDIR/inputs.pt names a free one). Torch runs
on one intra-op thread, so runs repeat bit for bit.
"""
import copy
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the Trainer's StatsTracker writes metrics.jsonl without TensorBoard, whose
# first import costs seconds a process
sys.modules["torch.utils.tensorboard"] = None

from multi_modal_tracking_torch.models import asymmetric_shared as port_as  # noqa: E402
from multi_modal_tracking_torch.models.layers import BatchNorm2d, set_sync_group  # noqa: E402
from multi_modal_tracking_torch.parallel import distributed as D  # noqa: E402
from multi_modal_tracking_torch.parallel.mesh import (DataParallel, fsdp_shard,  # noqa: E402
                                                      local_tensor)
from multi_modal_tracking_torch.train import optimizer as port_opt  # noqa: E402
from multi_modal_tracking_torch.train import train_step as port_ts  # noqa: E402


def _group(workdir, name, rank, world):
    D.initialize_distributed(f"file://{workdir}/store_{name}", world, rank, device="cpu")
    return DataParallel()


def _model(inp):
    m = port_as.MixFormerRGBT(port_as.RGBTSpec(**inp["geom"], drop_path_rate=0.0,
                                               fusion_dropout=0.0))
    m.load_state_dict(inp["state"], strict=True)
    return m


def _local(batch, rank, world):
    """This rank's part of a global (t, ot, s, gt) batch: each modality's
    slice of the samples, the RGB half then the TIR half."""
    t, ot, s, gt = batch
    B = gt.shape[0]
    b = B // world
    lo, hi = rank * b, (rank + 1) * b

    def part(x):
        return torch.cat([x[lo:hi], x[B + lo:B + hi]])
    return {"t": part(t), "ot": part(ot), "s": part(s), "gt_xywh": gt[lo:hi]}


def _full(t):
    """The whole tensor of a sharded one."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _step_case(inp, dp, accum, rank, world):
    """One update (two micro-batches at ACCUM_ITER 2) on the rank's part of
    the batches; the metrics, parameters, buffers and clipped gradients."""
    cfg = copy.deepcopy(inp["cfg"])
    cfg.TRAIN.ACCUM_ITER = accum
    model = _model(inp)
    if dp is not None:
        set_sync_group(model, dp.group)
    opt = port_opt.make_optimizer(cfg, model, steps_per_epoch=4, dp=dp)
    step = port_ts.make_train_step(model, opt, device="cpu", dp=dp)
    metrics = []
    for batch in inp["batches"][:accum]:
        x = _local(batch, rank, world) if dp is not None else _local(batch, 0, 1)
        metrics.append({k: float(v) for k, v in step(x, ce_keep_rate=1.0).items()})
    return dict(metrics=metrics,
                params={k: p.detach().clone() for k, p in model.named_parameters()},
                buffers={k: b.clone() for k, b in model.named_buffers()},
                grads={k: g.clone() for k, g in zip((n for n, _ in model.named_parameters()),
                                                      opt.grads)})


def case_dp(rank, world, workdir, inp):
    out = {}
    dp = _group(workdir, "dp", rank, world)
    out["dp"] = _step_case(inp, dp, 1, rank, world)
    out["dp_accum"] = _step_case(inp, dp, 2, rank, world)
    # synced BN on this rank's half of x against BN on the whole batch
    x, gy = inp["bn_x"], inp["bn_gy"]
    n = x.shape[0] // world
    xl = x[rank * n:(rank + 1) * n].clone().requires_grad_(True)
    bn = BatchNorm2d(x.shape[1])
    bn.load_state_dict(inp["bn_state"])
    bn.process_group = dp.group
    bn.train()
    y = bn(xl)
    (y * gy[rank * n:(rank + 1) * n]).sum().backward()
    out["bn"] = dict(y=y.detach(), running_mean=bn.running_mean.clone(),
                     running_var=bn.running_var.clone(), x_grad=xl.grad,
                     weight_grad=bn.weight.grad, bias_grad=bn.bias.grad)
    out["generator_seed"] = D.process_seed(10)
    out["main"] = D.is_main_process()
    D.shutdown_distributed()

    # torchrun's environment forms the group
    env = dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(inp["port"]))
    os.environ.update(env)
    formed = D.initialize_distributed(device="cpu")
    t = torch.tensor([float(rank + 1)])
    torch.distributed.all_reduce(t)
    out["torchrun"] = dict(formed=formed, world=D.world_size(), rank=D.rank(), sum=float(t))
    D.shutdown_distributed()
    for k in env:
        del os.environ[k]

    # the training command under two processes, then its resume; then with
    # its fail-safe on and rank 1 failing
    out["run"] = _run_case(rank, world, workdir, inp)
    out["fail"] = _fail_case(rank, world, workdir, inp)
    return out


def _tiny_cli(inp, train_epoch=None):
    """train.run's main with its Trainer at the tiny geometry on the tiny
    config (and `train_epoch` in place of the Trainer's, if given)."""
    import multi_modal_tracking_torch.config as config_mod
    import multi_modal_tracking_torch.train.trainer as trainer_mod
    from multi_modal_tracking_torch.train import run

    config_mod.get_default_config = lambda script: copy.deepcopy(inp["run_cfg"])

    class Tiny(trainer_mod.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, spec_overrides=inp["tiny"], **kw)
    if train_epoch is not None:
        Tiny.train_epoch = train_epoch

    def main(argv):
        base, trainer_mod.Trainer = trainer_mod.Trainer, Tiny
        try:
            return run.main(argv)
        finally:
            trainer_mod.Trainer = base
    return main


def _cli_argv(workdir, name, rank, world):
    return ["--script", "asymmetric_shared_ce", "--save_dir", os.path.join(workdir, name),
            "--device", "cpu", "--dtype", "float32", "--epochs", "1",
            "--num_processes", str(world), "--process_id", str(rank)]


def _run_case(rank, world, workdir, inp):
    main = _tiny_cli(inp)
    argv = _cli_argv(workdir, "run", rank, world) + ["--no_fail_safe"]
    first = main(argv + ["--coordinator", f"file://{workdir}/store_run1"])
    after = main(argv + ["--coordinator", f"file://{workdir}/store_run2", "--resume"])
    same = dict(epoch=(first.epoch, after.epoch),
                model=all(torch.equal(a, b) for a, b in
                          zip(first.model.state_dict().values(),
                              after.model.state_dict().values())),
                optimizer=_same_optimizer(first.optimizer, after.optimizer),
                generator=torch.equal(first.generator.get_state(),
                                      after.generator.get_state()))
    return dict(same=same, generator=first.generator.get_state(),
                initialized_after=torch.distributed.is_initialized())


def _fail_case(rank, world, workdir, inp):
    """train.run with its fail-safe restart on (the default), rank 1 raising
    as its first epoch begins: each rank's error and the epochs it began."""
    from multi_modal_tracking_torch.train.trainer import Trainer
    began = []

    def train_epoch(self):
        began.append(self.epoch)
        if rank == 1:
            raise RuntimeError("injected failure on rank 1")
        return Trainer.train_epoch(self)
    main = _tiny_cli(inp, train_epoch)
    try:
        main(_cli_argv(workdir, "fail", rank, world)
             + ["--coordinator", f"file://{workdir}/store_fail"])
        error = None
    except Exception as e:      # the case's result: the error each rank raised
        error = f"{type(e).__name__}: {e}"
    return dict(error=error, began=began, initialized_after=torch.distributed.is_initialized())


def _same_optimizer(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    if (sa["count"], sa["mini_step"]) != (sb["count"], sb["mini_step"]):
        return False
    return all(torch.equal(x[k], sb["adamw"]["state"][i][k])
               for i, x in sa["adamw"]["state"].items() for k in x)


def _state_bytes(opt):
    """This rank's bytes of parameters and AdamW moments."""
    params = sum(local_tensor(p).numel() * 4 for p in opt.params)
    moments = sum(m.numel() * 4 for g in opt.groups for m in opt.mu[g] + opt.nu[g])
    return params, moments


def case_fsdp(rank, world, workdir, inp):
    out = {}
    dp = _group(workdir, "fsdp", rank, world)
    cfg = inp["cfg"]
    res = {}
    for name in ("dp", "fsdp"):
        model = _model(inp)
        set_sync_group(model, dp.group)
        replicated = fsdp_shard(model, dp, min_size=inp["min_size"]) if name == "fsdp" else None
        opt = port_opt.make_optimizer(cfg, model, steps_per_epoch=4, dp=dp)
        step = port_ts.make_train_step(model, opt, device="cpu", dp=dp)
        m = {k: float(v) for k, v in
             step(_local(inp["batches"][0], rank, world), ce_keep_rate=1.0).items()}
        res[name] = dict(metrics=m, bytes=_state_bytes(opt),
                         params={k: _full(p).detach().clone()
                                 for k, p in model.named_parameters()},
                         n_sharded=sum(opt.sharded),
                         replicated_bytes=sum(p.numel() * 4 for p in replicated or ()))
    out["step"] = res

    # the Trainer under FSDP: an epoch, its sharded checkpoint, the resume
    from multi_modal_tracking_torch.train.trainer import Trainer
    save = os.path.join(workdir, "fsdp_run")
    cfg = copy.deepcopy(inp["run_cfg"])
    cfg.TRAIN.FSDP = True

    def trainer():
        return Trainer("asymmetric_shared_ce", cfg, save_dir=save, device="cpu", seed=0,
                       spec_overrides=inp["tiny"], dtype=torch.float32)
    first = trainer()
    first.train(max_epochs=1, fail_safe=False)
    after = trainer()
    assert after.load_checkpoint()

    def full_state(tr):
        return {k: _full(v).detach().clone() for k, v in tr.model.state_dict().items()}

    def moments(tr):
        return [m.clone() for g in tr.optimizer.groups
                for m in tr.optimizer.mu[g] + tr.optimizer.nu[g]]
    sa, sb = full_state(first), full_state(after)
    out["resume"] = dict(
        epoch=(first.epoch, after.epoch), count=(first.optimizer.count, after.optimizer.count),
        model=all(torch.equal(sa[k], sb[k]) for k in sa),
        moments=all(torch.equal(a, b) for a, b in zip(moments(first), moments(after))),
        generator=torch.equal(first.generator.get_state(), after.generator.get_state()),
        path=os.path.join(save, "checkpoints", "asymmetric_shared_ce"))
    out["full_state"] = sa
    out["full_moments"] = {i: _full(t).clone() for i, t in
                           enumerate(first.optimizer.sharded_state_dict().values())
                           if t.dim() > 0}
    D.shutdown_distributed()
    return out


def main():
    case, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = globals()[f"case_{case}"](rank, world, workdir, inp)
    torch.save(out, os.path.join(workdir, f"{case}_{rank}.pt"))


if __name__ == "__main__":
    main()
