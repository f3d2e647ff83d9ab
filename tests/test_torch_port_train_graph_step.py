"""The trainer's static-buffer step (the step that tracking/graphs.py
`StepGraphs.run` captures as CUDA graphs on the card, one per keep bucket
and accumulation role) run eager on the CPU, at the tiny flagship geometry
of tests/test_torch_port_model.py (embed 64, depth 4, CE at blocks 1/3,
search 176, template 112, CORNER_UP head) at batch 1, with drop path and
the fusion's dropout on:

  * over 4 steps it equals, bit for bit, the step as the port ran it before
    its state moved into static buffers (`_ReferenceStep` below: `.grad`
    set to None before each backward, a fresh accumulator per group, the
    CE ranking's template rows gathered with a Python list, the learning
    rate and the accumulation divisor from the host), with the same
    optimizer arithmetic (`ops.adamw.adamw_ref`, `clip_by_global_norm_`):
    parameters, AdamW moments, BN buffers, every step's metrics, the
    generator's state and the host's counters; f32 and bf16, keep 1.0 and
    a bucketed keep < 1, ACCUM_ITER 1 and 2. The optimizer against optax
    stays in tests/test_torch_port_train_step.py (1e-6) and
    tests/test_torch_port_lifecycle.py (MultiSteps);
  * a step dispatches no operation that a CUDA graph cannot hold: no
    `aten._local_scalar_dense` (a value read on the host), `aten.nonzero`
    (an output size from the device) or `aten.lift_fresh` (a tensor made
    from host data), forward, backward and update included;
  * the CE ranking's strided template rows are those of the old list index,
    bit for bit;
  * `Trainer.load_checkpoint` loads into the tensors the step holds, in
    place, and the optimizer loads torch.optim.AdamW's checkpoint layout.
"""
import copy

import numpy as np
import pytest
import torch

from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.models.build import build_model
from multi_modal_tracking_torch.models.layers import set_generator
from multi_modal_tracking_torch.ops import adamw as port_adamw
from multi_modal_tracking_torch.tracking.graphs import OpLog
from multi_modal_tracking_torch.train import optimizer as port_opt
from multi_modal_tracking_torch.train import train_step as port_ts
from multi_modal_tracking_torch.train.losses import box_losses

from tests.test_torch_port_batched import one_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_port_trainer import TINY, _cfg

SCRIPT = "asymmetric_shared_ce"
B = 1
N_STEPS = 4
N_S = (176 // 16) ** 2               # search tokens of the tiny geometry
KEEP = port_ts.bucketize_keep_rate(0.74, N_S)
FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _batches(n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xy = rng.uniform(0.2, 0.5, (B, 2))
        wh = rng.uniform(0.15, 0.35, (B, 2))
        out.append({"t": torch.from_numpy(rng.standard_normal((2 * B, 112, 112, 3), np.float32)),
                    "ot": torch.from_numpy(rng.standard_normal((2 * B, 112, 112, 3),
                                                               np.float32)),
                    "s": torch.from_numpy(rng.standard_normal((2 * B, 176, 176, 3), np.float32)),
                    "gt_xywh": torch.from_numpy(np.concatenate([xy, wh], 1).astype(np.float32))})
    return out


def _setup(dtype, accum):
    cfg = _cfg()
    cfg.TRAIN.ACCUM_ITER = accum
    model = build_model(SCRIPT, cfg, device="cpu", dtype=dtype, seed=0,
                        spec_overrides=dict(TINY, drop_path_rate=0.1)).train()
    set_generator(model, torch.Generator().manual_seed(11))
    return cfg, model, port_opt.make_optimizer(cfg, model, steps_per_epoch=4)


def _old_t2s_attention(q_mt, k_s, scale, ce_rows):
    """`_t2s_attention` as it was: the rows gathered with a Python list."""
    if ce_rows is not None:
        q_mt = q_mt[:, :, list(range(q_mt.shape[2]))[ce_rows]]
    a = torch.matmul(q_mt, k_s.transpose(-2, -1)) * scale
    return torch.softmax(a.float(), dim=-1)


class _ReferenceStep:
    """The step as the port ran it before the static buffers, on its own
    copy of the model, with its own moments and host counters."""

    def __init__(self, model, opt):
        self.model, self.opt = model, opt
        self.count, self.mini_step, self.acc = 0, 0, None

    def neg_lr(self, g):
        return torch.tensor(-(self.opt.base_lr * self.opt.mults[g] * self.opt.scale(self.count)))

    @torch.no_grad()
    def update(self):
        o = self.opt
        grads = []
        for p in o.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if o.accum == 1:
            norm = port_opt.clip_by_global_norm_(grads, o.max_norm)
        else:
            norm = port_opt.global_norm(grads)
            if self.mini_step == 0:
                self.acc = [g.clone() for g in grads]
            else:
                diff = torch._foreach_sub(grads, self.acc)
                torch._foreach_div_(diff, float(self.mini_step + 1))
                torch._foreach_add_(self.acc, diff)
            self.mini_step += 1
            if self.mini_step < o.accum:
                return norm
            for p, a in zip(o.params, self.acc):
                p.grad = a
            self.acc, self.mini_step = None, 0
            grads = [p.grad for p in o.params]
            port_opt.clip_by_global_norm_(grads, o.max_norm)
        bc1, bc2 = (torch.tensor(1.0 - b ** (self.count + 1)) for b in (port_adamw.B1,
                                                                      port_adamw.B2))
        for g, ps in o.groups.items():
            port_adamw.adamw_ref(ps, [grads[i] for i in o._index[g]], o.mu[g], o.nu[g],
                                 self.neg_lr(g), bc1, bc2, o.weight_decay)
        self.count += 1
        return norm

    def __call__(self, x, keep, monkeypatch):
        monkeypatch.setattr(port_as, "_t2s_attention", _old_t2s_attention)
        try:
            self.model.train()
            for p in self.opt.params:
                p.grad = None
            out = self.model(x["t"], x["ot"], x["s"], keep)
            loss, metrics = box_losses(out["pred_boxes"], x["gt_xywh"], 2.0, 5.0)
            loss.backward()
            norm = self.update()
        finally:
            monkeypatch.undo()
        return dict({k: v.detach() for k, v in metrics.items()}, grad_norm=norm)


def _gen(model):
    return next(m.generator for m in model.modules() if getattr(m, "generator", None) is not None)


@pytest.mark.parametrize("accum", [1, 2], ids=["accum1", "accum2"])
@pytest.mark.parametrize("keep", [1.0, KEEP], ids=["keep1", "keep_bucket"])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_static_step_equals_the_step_before(dtype, keep, accum, monkeypatch):
    cfg, model, opt = _setup(DTYPES[dtype], accum)
    ref_model = copy.deepcopy(model)
    set_generator(ref_model, torch.Generator().manual_seed(11))
    ref = _ReferenceStep(ref_model, port_opt.make_optimizer(cfg, ref_model, steps_per_epoch=4))
    step = port_ts.make_train_step(model, opt, device="cpu")
    assert step.graphs is None
    init = [p.detach().clone() for p in model.parameters()]
    for x in _batches(N_STEPS):
        got, want = step(x, ce_keep_rate=keep), ref(x, keep, monkeypatch)
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), (k, got[k], want[k])
    assert (opt.count, opt.mini_step) == (ref.count, ref.mini_step) == (N_STEPS // accum, 0)
    sa, sb = model.state_dict(), ref_model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for g in opt.groups:
        for a, b in zip(opt.mu[g] + opt.nu[g], ref.opt.mu[g] + ref.opt.nu[g]):
            assert torch.equal(a, b), g
    assert torch.equal(_gen(model).get_state(), _gen(ref_model).get_state())
    assert any(not torch.equal(p, q) for p, q in zip(model.parameters(), init))


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_step_dispatches_nothing_a_graph_cannot_hold(dtype):
    """Both roles of ACCUM_ITER 2 at a keep < 1 (CE's top-k, gather and
    scatter under autograd), and the backward's operations are in the log.
    The first step fills the first-use caches (the fusion's reference
    points): on the card it is the key's eager step, before the capture."""
    _, model, opt = _setup(DTYPES[dtype], 2)
    step = port_ts.make_train_step(model, opt, device="cpu")
    x0, *xs = _batches(3)
    step(x0, ce_keep_rate=KEEP)
    for x in xs:
        with OpLog() as log:
            step(x, ce_keep_rate=KEEP)
        bad = sorted({op for op in log.ops if op.startswith(FORBIDDEN)})
        assert not bad, bad
        assert any("backward" in op for op in log.ops)
        assert "aten._foreach_add_.List" in log.ops
    assert opt.count == 1


def test_ce_rows_slice_selects_the_list_rows():
    """The strided rows equal the old list index's bit for bit, and a CE
    forward in training dispatches no aten.lift_fresh."""
    torch.manual_seed(0)
    model = build_model(SCRIPT, _cfg(), device="cpu", seed=0,
                        spec_overrides=dict(TINY, drop_path_rate=0.1)).train()
    set_generator(model, torch.Generator().manual_seed(1))
    F = model.backbone.grid_size_t
    rows = model.backbone._ce_rows(True)
    c = (F - 1) // 2
    old = tuple(c * F + c + g * F * F for g in range(4))
    q = torch.randn(2, 4, 4 * F * F, 16)
    assert torch.equal(q[:, :, rows], q[:, :, list(old)])
    k = torch.randn(2, 4, 2 * N_S, 16)
    assert torch.equal(port_as._t2s_attention(q, k, 0.25, rows),
                       _old_t2s_attention(q, k, 0.25, rows))
    x0, x = _batches(2)
    model(x0["t"], x0["ot"], x0["s"], KEEP)           # fills the fusion's first-use cache
    with OpLog() as log:
        model(x["t"], x["ot"], x["s"], KEEP)
    assert not [op for op in log.ops if op.startswith("aten.lift_fresh")]
    assert any(op.startswith("aten.topk") for op in log.ops)


def test_load_checkpoint_writes_into_the_step_tensors(tmp_path):
    """Every tensor the step holds keeps its storage through
    Trainer.load_checkpoint (the resume and the fail-safe restart), and
    takes the checkpoint's values: a graph captured before stays bound."""
    from multi_modal_tracking_torch.train.trainer import Trainer
    from tests.test_torch_port_isolation import TINY as TINIEST, _train_cfg
    cfg = _train_cfg(small=True)
    cfg.TRAIN.ACCUM_ITER = 2
    cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = 6                 # three micro-batches: one left open
    tr = Trainer(SCRIPT, cfg, save_dir=str(tmp_path), device="cpu", seed=0,
                 spec_overrides=TINIEST, dtype=torch.float32)
    tr.epoch = 1
    tr.cycle_dataset()
    assert (tr.optimizer.count, tr.optimizer.mini_step) == (1, 1)
    tr.save_checkpoint()
    opt = tr.optimizer
    state = list(opt.params) + list(tr.model.buffers()) + opt._acc + \
        [t for g in opt.groups for t in opt.mu[g] + opt.nu[g]]
    held = state + opt.grads + [opt._neg_lr, opt._bc, opt._n]
    ptrs = [t.data_ptr() for t in held]
    saved = [t.detach().clone() for t in state]
    tr.cycle_dataset()                                  # move everything on
    assert (opt.count, opt.mini_step) == (3, 0)
    assert tr.load_checkpoint()
    assert [t.data_ptr() for t in held] == ptrs
    assert (opt.count, opt.mini_step) == (1, 1)
    assert all(torch.equal(t, s) for t, s in zip(state, saved))
    assert all(p.grad is g for p, g in zip(opt.params, opt.grads))


def test_optimizer_loads_torch_adamw_layout():
    """An earlier checkpoint's optimizer state (torch.optim.AdamW's
    state_dict over the same groups, before and after a step) loads into
    the device state in place; state_dict() keeps that layout."""
    cfg = _cfg()
    model = torch.nn.Module()
    model.box_head = torch.nn.Linear(3, 2)
    model.backbone = torch.nn.Linear(2, 2)
    opt = port_opt.make_optimizer(cfg, model)
    groups = [dict(params=ps, group=g) for g, ps in opt.groups.items()]
    old = torch.optim.AdamW(groups, lr=1e-4, weight_decay=1e-4)
    empty = {"adamw": old.state_dict(), "count": 0, "mini_step": 0, "acc": None}
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    old.step()
    ptrs = [t.data_ptr() for g in opt.groups for t in opt.mu[g] + opt.nu[g]]
    opt.load_state_dict({"adamw": old.state_dict(), "count": 1, "mini_step": 0, "acc": None})
    for g, ps in opt.groups.items():
        for p, m, v in zip(ps, opt.mu[g], opt.nu[g]):
            assert torch.equal(m, old.state[p]["exp_avg"])
            assert torch.equal(v, old.state[p]["exp_avg_sq"])
    assert opt.count == 1
    assert [t.data_ptr() for g in opt.groups for t in opt.mu[g] + opt.nu[g]] == ptrs
    sd = opt.state_dict()
    assert sd["adamw"]["state"].keys() == old.state_dict()["state"].keys()
    assert [g["params"] for g in sd["adamw"]["param_groups"]] == \
        [g["params"] for g in old.state_dict()["param_groups"]]
    opt.load_state_dict(empty)
    assert all(not t.any() for g in opt.groups for t in opt.mu[g] + opt.nu[g])
