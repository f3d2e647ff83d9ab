"""One rank of the port's multi-process CPU tests (gloo): run as

    python tests/torch_port_parallel_worker.py CASE RANK WORLD WORKDIR

by tests/test_torch_port_parallel.py, tests/test_torch_port_fsdp.py,
tests/test_torch_port_tensor_parallel.py and
tests/test_torch_port_tensor_parallel_families.py, which write
`WORKDIR/inputs.pt` first and read `WORKDIR/<case>_<rank>.pt` after. Each
case forms its groups through `file://` stores under WORKDIR (no port
shared between test processes), except the torchrun bootstrap, which
needs MASTER_PORT (WORKDIR/inputs.pt names a free one). Torch runs on one
intra-op thread, so runs repeat bit for bit.
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


def _model(inp, drop: float = 0.0):
    m = port_as.MixFormerRGBT(port_as.RGBTSpec(**inp["geom"], drop_path_rate=drop,
                                               fusion_dropout=drop))
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
    # its fail-safe on and rank 1 failing; then a non-finite loss on both
    out["run"] = _run_case(rank, world, workdir, inp)
    out["fail"] = _fail_case(rank, world, workdir, inp)
    out["restart"] = _restart_case(rank, world, workdir, inp)
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


def _restart_case(rank, world, workdir, inp):
    """train.run for two epochs with its fail-safe restart on, rank 1's
    boxes NaN in epoch 2's first try: the averaged loss is non-finite on
    both ranks, and both restart from epoch 1's checkpoint.
    Each rank's epochs begun, its restarts and its final state."""
    from multi_modal_tracking_torch.train.trainer import Trainer
    began, loads = [], []

    def train_epoch(self):
        began.append(self.epoch)
        if self.epoch != 2 or began.count(2) > 1 or rank != 1:
            return Trainer.train_epoch(self)
        step = self._step

        def poisoned(inputs, ce_keep_rate=None):
            return step(dict(inputs, gt_xywh=inputs["gt_xywh"] * float("nan")), ce_keep_rate)
        self._step = poisoned
        try:
            return Trainer.train_epoch(self)
        finally:
            self._step = step

    base = Trainer.load_checkpoint

    def load_checkpoint(self, path=None, reshard=False):
        loads.append(self.epoch)
        return base(self, path, reshard)
    main = _tiny_cli(inp, train_epoch)
    Trainer.load_checkpoint = load_checkpoint
    try:
        argv = _cli_argv(workdir, "restart", rank, world)
        argv[argv.index("--epochs") + 1] = "2"
        tr = main(argv + ["--coordinator", f"file://{workdir}/store_restart"])
    finally:
        Trainer.load_checkpoint = base
    return dict(began=began, loads=loads, epoch=tr.epoch, count=tr.optimizer.count,
                state={k: v.clone() for k, v in tr.model.state_dict().items()},
                initialized_after=torch.distributed.is_initialized())


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


def case_tp(rank, world, workdir, inp):
    """One step of the tiny flagship over a 2 x 2 data x model group (CE at
    the input's keep), each data rank on its part of the global batch;
    the metrics, the whole parameters and clipped gradients gathered over
    the model group, and this rank's own state."""
    from multi_modal_tracking_torch.parallel.mesh import create_mesh_2d
    from multi_modal_tracking_torch.parallel.tensor import (
        gather_state_dict, set_tensor_parallel_generators, shard_tensor_parallel_,
        tensor_parallel_seeds)
    D.initialize_distributed(f"file://{workdir}/store_tp", world, rank, device="cpu")
    out = {}
    try:
        create_mesh_2d(3, 1)
    except ValueError as e:
        out["wrong_world"] = str(e)
    tp = create_mesh_2d(2, 2)
    out["grid"] = (tp.data_rank, tp.model_rank, tp.data.world, tp.model.world)
    model = _model(inp)
    dims = shard_tensor_parallel_(model, tp)
    opt = port_opt.make_optimizer(inp["cfg"], model, steps_per_epoch=4, tp=tp)
    step = port_ts.make_train_step(model, opt, device="cpu", tp=tp)
    x = _local(inp["batches"][0], tp.data_rank, tp.n_data)
    out["metrics"] = {k: float(v) for k, v in step(x, ce_keep_rate=inp["keep"]).items()}
    names = [n for n, _ in model.named_parameters()]
    out["grads"] = gather_state_dict(dict(zip(names, opt.grads)), dims, tp.model)
    out["params"] = gather_state_dict(dict(model.named_parameters()), dims, tp.model)
    out["local"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out["dims"] = dims
    out["heads"] = model.backbone.blocks[0].attn.num_heads
    # drop path and dropout on: masks from the generators of Megatron's rule
    model = _model(inp, drop=0.1)
    shard_tensor_parallel_(model, tp)
    out["seeds"] = tensor_parallel_seeds(7, tp)
    set_tensor_parallel_generators(model, *(torch.Generator().manual_seed(s)
                                            for s in out["seeds"]))
    out["sharded_masks"] = sorted(n for n, m in model.named_modules()
                                  if getattr(m, "generator", None) is not None
                                  and m.generator is not model.backbone.blocks[0].dp1.generator)
    opt = port_opt.make_optimizer(inp["cfg"], model, steps_per_epoch=4, tp=tp)
    step = port_ts.make_train_step(model, opt, device="cpu", tp=tp)
    out["dropped_metrics"] = {k: float(v) for k, v in
                              step(x, ce_keep_rate=inp["keep"]).items()}
    out["dropped_local"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    D.shutdown_distributed()
    return out


def _conv_check(conv, x: torch.Tensor, gy: torch.Tensor, group) -> dict:
    """RowParallelConv2d over `group` holding this rank's input channels of
    `conv` against `conv` on the whole NCHW input: the largest differences
    of the output, the input gradient and the weight gradient (this rank's
    slice), each over the largest magnitude of the whole conv's."""
    from multi_modal_tracking_torch.parallel.tensor import RowParallelConv2d
    n, r = group.world, group.rank
    conv = copy.deepcopy(conv)
    rp = RowParallelConv2d(conv.in_channels // n, conv.out_channels, conv.kernel_size,
                           conv.stride, conv.padding, conv.dilation, conv.bias is not None,
                           group)
    with torch.no_grad():
        rp.weight.copy_(conv.weight.chunk(n, dim=1)[r])
        rp.bias.copy_(conv.bias)
    xa, xb = (x.detach().clone().requires_grad_(True) for _ in range(2))
    ya, yb = rp(xa), conv(xb)
    (ya * gy).sum().backward()
    (yb * gy).sum().backward()
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    return dict(output=rel(ya, yb), input_grad=rel(xa.grad, xb.grad),
                weight_grad=rel(rp.weight.grad, conv.weight.grad.chunk(n, dim=1)[r]))


def _digest(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.detach().reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()


def case_tp_families(rank, world, workdir, inp):
    """One step of each family's tiny model over a 2 x 2 data x model group,
    each data rank on its samples of the global batch, held here against
    the one-process step of the inputs (`want`; the states are too large
    to send back whole): the metrics; the largest difference of each
    clipped gradient and BN statistic (gathered over the model group); the
    largest excess of each gathered parameter over 1e-6 + lr |dg| / eps;
    digests of this rank's tensors and of the gathered parameters; whether
    the cut parameters were `shard_state_dict` of the whole ones and
    gathering them gave those back. And RowParallelConv2d against the
    whole convolution on the inputs of CvT's and ConvMAE's row-parallel
    patch embeddings."""
    from multi_modal_tracking_torch.parallel.mesh import create_mesh_2d
    from multi_modal_tracking_torch.parallel.tensor import (
        RowParallelConv2d, gather_state_dict, shard_state_dict, shard_tensor_parallel_)
    D.initialize_distributed(f"file://{workdir}/store_tp_families", world, rank, device="cpu")
    tp = create_mesh_2d(2, 2)
    out = {"grid": (tp.data_rank, tp.model_rank)}
    for family, f in inp["families"].items():
        want = f["want"]
        model = copy.deepcopy(f["model"])
        whole = {k: v.detach().clone() for k, v in model.named_parameters()}
        dims = shard_tensor_parallel_(model, tp)
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        back = gather_state_dict(before, dims, tp.model)
        cut = shard_state_dict(whole, dims, tp.model_rank, tp.n_model)
        cfg = copy.deepcopy(f["cfg"])
        opt = port_opt.make_optimizer(cfg, model, steps_per_epoch=4, tp=tp)
        step = port_ts.make_train_step(model, opt, device="cpu", tp=tp,
                                       train_score=f["train_score"],
                                       score_weight=cfg.TRAIN.get("SCORE_WEIGHT", 1.0))
        B = f["batch"]["gt_xywh"].shape[0]
        lo, hi = tp.data_rank * B // tp.n_data, (tp.data_rank + 1) * B // tp.n_data
        calls = RowParallelConv2d.calls
        metrics = step({k: v[lo:hi] for k, v in f["batch"].items()}, ce_keep_rate=f["keep"])
        names = [n for n, _ in model.named_parameters()]
        grads = gather_state_dict(dict(zip(names, opt.grads)), dims, tp.model)
        params = gather_state_dict(dict(model.named_parameters()), dims, tp.model)
        local = model.state_dict()
        lr = f["lr"]
        out[family] = dict(
            metrics={k: float(v) for k, v in metrics.items()}, dims=dims,
            grad_keys=sorted(grads),
            grad_err={k: float((grads[k] - w).abs().max()) for k, w in want["grads"].items()},
            param_excess={k: float(((params[k] - w).abs() - 1e-6 - lr * (
                grads[k] - want["grads"][k]).abs() / port_opt.EPS).max())
                for k, w in want["params"].items()},
            buffer_err={k: float((local[k].double() - w.double()).abs().max())
                        for k, w in want["buffers"].items()},
            local_digests={k: _digest(v) for k, v in local.items()},
            param_digests={k: _digest(v) for k, v in params.items()},
            running_stats=sorted(k for k in local if k.endswith("running_var")),
            cut_is_shard=before.keys() == cut.keys() and all(torch.equal(before[k], cut[k])
                                                             for k in cut),
            gathered_equal=back.keys() == whole.keys() and all(torch.equal(back[k], whole[k])
                                                               for k in whole),
            heads=[m.num_heads for m in model.modules() if hasattr(m, "set_model_group")],
            total_heads=[m.total_heads for m in model.modules() if hasattr(m, "set_model_group")],
            row_parallel_convs=RowParallelConv2d.calls - calls)
    # the row-parallel convolution on the maps CvT's and ConvMAE's embeddings get
    g = torch.Generator().manual_seed(5)
    cvt = inp["families"]["cvt"]["model"].backbone.stage1.patch_embed.proj
    cm = inp["families"]["convmae"]["model"].backbone.patch_embed2.proj
    checks = {}
    for case, conv, hw in (("cvt_template", cvt, 8), ("cvt_search", cvt, 16),
                           ("convmae_template", cm, 8)):
        # channels-last NCHW views of NHWC maps, as the models pass them
        x = torch.randn(2, hw, hw, conv.in_channels, generator=g).permute(0, 3, 1, 2)
        oh = (hw + 2 * conv.padding[0] - conv.kernel_size[0]) // conv.stride[0] + 1
        gy = torch.randn(2, conv.out_channels, oh, oh, generator=g)
        checks[case] = _conv_check(conv, x, gy, tp.model)
    out["conv_check"] = checks
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
