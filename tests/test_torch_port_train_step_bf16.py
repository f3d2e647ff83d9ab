"""The port's bf16 training step (compute dtype bf16 on float32 parameters,
flax dtype=bf16 / param_dtype=float32) against `jax.grad` of the JAX
package's bf16 model, on the tiny geometry and batch of
tests/test_torch_port_train_step.py (width 64, 4 heads, depth 4, CE at
blocks 1/3, CORNER_UP head, LNSpecific fusion with 2 layers, batch 2, the
same perturbed weights, dropout and drop path off).

bf16 gradients of this loss are far from the f32 ones in both frameworks:
JAX's own bf16 gradient lies about 0.5 G from its f32 gradient (G the f32
global grad norm; per tensor up to ~50 %, led by the MSDA sampling-offset
kernels and the patch embedding), because the head's training-mode
BatchNorms over a few pixels and the soft-argmax amplify the bf16
roundings of the activations. The two frameworks also round at different
points (JAX's bf16 model on the CPU attends through its XLA lowering,
scores rounded to bf16; the port like the Pallas kernel, f32 scores), so
the port is held to JAX's own bf16 drift, measured in the test:
  * ||g_port - g_jax_bf16|| <= 2 ||g_jax_bf16 - g_jax_f32||   (global)
  * ||g_port - g_jax_f32||  <= 1.5 ||g_jax_bf16 - g_jax_f32||
    (measured: 0.57 G and 0.50 G against JAX's 0.50 G; the port's f32
    step, for scale, lies 0.0024 G from JAX f32);
  * |loss_port - loss_jax_f32| <= 2^-6 |loss_jax_f32|, four bf16 units:
    the loss of a bf16 forward drifts from f32 by a few tenths of a percent
    in both frameworks (measured over six batches of this geometry: JAX
    bf16 0.01 % to 0.43 %, the port 0.04 % to 0.41 %; here the port 0.41 %
    and JAX 0.04 %).
This comparison is made at CE keep 1.0. At keep 0.7 the CE ranking's bf16
scores hold near-ties (relative gaps of 7e-5 to 1e-2 between the last kept
and the first dropped candidate, against bf16's 4e-3 rounding): the port's
own bf16 and f32 steps keep different tokens at every CE block, so no
framework comparison is meaningful there; the keep 0.7 step is checked
for its dtypes, finite values and the kernels it reaches.

Also: parameters, gradients and AdamW moments stay float32; no f32
attention or MSDA function is reached on the bf16 path; `Trainer` with no
dtype argument and with TRAIN.AMP True trains in bf16 without raising.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as

from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.models.layers import compute_dtype, set_compute_dtype
from multi_modal_tracking_torch.train import optimizer as port_opt
from multi_modal_tracking_torch.train import train_step as port_ts
from multi_modal_tracking_torch.train.losses import box_losses
from multi_modal_tracking_torch.utils.convert import from_jax_variables
from tests.test_torch_port_model import GEOM, S_SZ, T_SZ, _randomise
from tests.test_torch_port_train_step import _batch, _flagship_cfgs, _jax_grads

#: the f32 plain versions, which the bf16 path must not reach
F32_OPS = {"multi_modal_tracking_torch.ops.attention": (
    "mixed_attention_ref", "mixed_attention_bwd_ref", "mixed_attention_lse_ref",
    "mixed_attention_fwd", "mixed_attention_bwd"),
    "multi_modal_tracking_torch.ops.msda": (
    "ms_deform_attn_ref", "ms_deform_attn_bwd_ref", "ms_deform_attn_fwd", "ms_deform_attn_bwd")}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_f32_ops(monkeypatch):
    """Every test here runs the bf16 path: an f32 attention or MSDA
    function raises if reached."""
    import importlib
    for mod, names in F32_OPS.items():
        m = importlib.import_module(mod)
        for name in names:
            monkeypatch.setattr(m, name, lambda *a, _n=name, **k: pytest.fail(f"{_n} reached"))


@pytest.fixture(scope="module")
def setup():
    spec = jax_as.RGBTSpec(**GEOM)
    jmodel = jax_as.MixFormerRGBT(spec=spec)
    tz = jnp.zeros((2, T_SZ, T_SZ, 3), jnp.float32)
    sz = jnp.zeros((2, S_SZ, S_SZ, 3), jnp.float32)
    variables = _randomise(jax.jit(jmodel.init)(jax.random.PRNGKey(0), tz, tz, sz), 0)
    batch = _batch(1)
    grads = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        g, metrics, _ = _jax_grads(jax_as.MixFormerRGBT(spec=spec, dtype=dtype), variables,
                                   batch, 1.0)
        grads[name] = (from_jax_variables({"params": g}), metrics["Loss/total"])
    pmodel = port_as.MixFormerRGBT(port_as.RGBTSpec(**GEOM, drop_path_rate=0.0,
                                                    fusion_dropout=0.0))
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    return variables, batch, grads, set_compute_dtype(pmodel, torch.bfloat16)


def _port_step(pmodel, batch, keep):
    pmodel.train()
    pmodel.zero_grad(set_to_none=True)
    t, ot, s, gt = (torch.from_numpy(x) for x in batch)
    out = pmodel(t, ot, s, keep)
    loss, _ = box_losses(out["pred_boxes"], gt, 2.0, 5.0)
    loss.backward()
    return {n: p.grad for n, p in pmodel.named_parameters()}, loss


def _dist(a, b):
    return float(torch.sqrt(sum(((a[k].double() - b[k].double()) ** 2).sum() for k in a)))


def test_bf16_step_within_jax_bf16_drift(setup):
    variables, batch, grads, pmodel = setup
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    got, loss = _port_step(pmodel, batch, 1.0)
    assert {p.dtype for p in pmodel.parameters()} == {torch.float32}
    assert {g.dtype for g in got.values()} == {torch.float32}
    assert loss.dtype == torch.float32
    (g32, l32), (g16, l16) = grads["f32"], grads["bf16"]
    assert got.keys() == g32.keys()
    jax_drift = _dist(g16, g32)
    to_jax16, to_jax32 = _dist(got, g16), _dist(got, g32)
    print(f"G {_dist(g32, {k: 0 * v for k, v in g32.items()}):.4g}; JAX bf16-f32 {jax_drift:.4g}; "
          f"port-JAX bf16 {to_jax16:.4g}; port-JAX f32 {to_jax32:.4g}; "
          f"loss {float(loss.detach()):.6f} JAX f32 {l32:.6f} bf16 {l16:.6f}")
    loss = float(loss.detach())
    assert 0 < jax_drift
    assert to_jax16 <= 2.0 * jax_drift, (to_jax16, jax_drift)
    assert to_jax32 <= 1.5 * jax_drift, (to_jax32, jax_drift)
    assert abs(loss - l32) <= 2.0 ** -6 * abs(l32), (loss, l32, l16)


def test_bf16_step_with_ce_and_optimizer_keeps_float32_state(setup):
    """keep 0.7 (CE's top-k, gather and zero-scatter under autograd in
    bf16), then the optimizer: finite f32 gradients reaching the MSDA and
    attention weights, and f32 parameters and AdamW moments after the
    update."""
    variables, batch, _, pmodel = setup
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    _, pcfg = _flagship_cfgs(drop_epoch=120)
    opt = port_opt.make_optimizer(pcfg, pmodel, steps_per_epoch=2)
    step = port_ts.make_train_step(pmodel, opt, device="cpu")
    t, ot, s, gt = (torch.from_numpy(x) for x in _batch(2))
    before = {n: p.detach().clone() for n, p in pmodel.named_parameters()}
    metrics = step({"t": t, "ot": ot, "s": s, "gt_xywh": gt}, ce_keep_rate=0.7)
    assert all(bool(torch.isfinite(v)) and v.dtype == torch.float32 for v in metrics.values())
    named = dict(pmodel.named_parameters())
    for name in ("backbone.blocks.0.attn.qkv.weight",
                 "fusion_vi.fusion_attention.encoder.layers.0.self_attn.value_proj.weight",
                 "fusion_vi.fusion_attention.encoder.layers.0.self_attn.sampling_offsets.weight"):
        g = named[name].grad
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert float(g.abs().max()) > 1e-6, name
        assert not torch.equal(named[name].detach(), before[name]), name
    assert {p.dtype for p in pmodel.parameters()} == {torch.float32}
    moments = [v for g in opt.groups for v in opt.mu[g] + opt.nu[g]]
    assert moments and {v.dtype for v in moments} == {torch.float32}
    assert compute_dtype(pmodel) == torch.bfloat16


def test_trainer_defaults_to_bf16_and_accepts_amp(tmp_path):
    """`Trainer` with no dtype argument builds float32 parameters that
    compute in bf16 (the JAX Trainer's only mode); TRAIN.AMP True changes
    nothing and raises nothing; an epoch trains with finite losses."""
    from multi_modal_tracking_torch.train.trainer import Trainer
    from tests.test_torch_port_isolation import TINY, _train_cfg
    cfg = _train_cfg(small=True)
    cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = 4                 # two steps of batch 2
    cfg.TRAIN.AMP = True
    tr = Trainer("asymmetric_shared_ce", cfg, save_dir=str(tmp_path), device="cpu", seed=0,
                 spec_overrides=TINY)
    assert tr.dtype == torch.bfloat16 and compute_dtype(tr.model) == torch.bfloat16
    assert {p.dtype for p in tr.model.parameters()} == {torch.float32}
    tr.epoch = 1
    tr.cycle_dataset()
    assert len(tr.history) == 2 and all(np.isfinite(v) for m in tr.history for v in m.values())
    assert {p.dtype for p in tr.model.parameters()} == {torch.float32}
