"""Alpha-Refine's bf16 form (compute in bfloat16 on float32 parameters,
flax's `dtype=`) against the JAX package's own bf16 form, at input 64 on the
variables of tests/torch_port_alpha_refine_common.py.

bf16 drifts from f32 by far more than the two packages differ at f32 (PR 20
saw 42 on random-weight logits of magnitude ~200), and the port's bf16 need
not round as JAX's does, so the port's bf16 is held to JAX's bf16 within
twice JAX's own bf16-to-f32 distance (the norm of the difference, per
output), not to f32 at a fixed tolerance:
  * the reference kernel and the mask logits of `init_ref` / the test
    branch;
  * ARcmSeg's sigmoid mask of a crop (`mask_crop`);
  * one refine step's loss within 2^-6 relative of JAX's bf16 step.
The parameters stay float32 throughout, and a dtype other than float32 or
bfloat16 raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.models import alpha_refine as jax_ar
from multi_modal_tracking_tpu.train import refine as jax_refine

from multi_modal_tracking_torch.models import alpha_refine as port_ar
from multi_modal_tracking_torch.train import refine as port_refine

from tests import torch_port_alpha_refine_common as common
from tests.test_torch_port_refine_train import LR, WD, _samples
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

S = common.INPUT_SZ


def _dist(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b))


def _jax_branches(dtype, p_ref, boxes, p_test):
    _, variables = common.jax_alpha_refine()
    net = jax_ar.AlphaRefineNet(spec=jax_ar.RefineSpec(input_sz=S, output_sz=S), dtype=dtype)

    def run(v, pr, b, pt):
        bound = net.bind(v)
        kernel = bound.init_ref(pr, b)
        return kernel.astype(jnp.float32), bound(pt, kernel).astype(jnp.float32)
    return [np.asarray(x) for x in jax.jit(run)(variables, p_ref, boxes, p_test)]


@pytest.fixture(scope="module")
def branches():
    rng = np.random.default_rng(0)
    p_ref = rng.standard_normal((2, S, S, 3)).astype(np.float32)
    p_test = rng.standard_normal((2, S, S, 3)).astype(np.float32)
    boxes = np.asarray([[16.0, 16.0, 32.0, 32.0], [20.0, 12.0, 24.0, 30.0]], np.float32)
    net = port_ar.set_refine_dtype(common.port_alpha_refine(), torch.bfloat16)
    t = torch.from_numpy
    with torch.no_grad():
        kernel = net.init_ref(t(p_ref), t(boxes))
        logits = net(t(p_test), kernel)
    return dict(net=net, port=(kernel.float().numpy(), logits.float().numpy()),
                f32=_jax_branches(jnp.float32, p_ref, boxes, p_test),
                bf16=_jax_branches(jnp.bfloat16, p_ref, boxes, p_test))


@pytest.mark.parametrize("which", ["kernel", "logits"])
def test_bf16_branches_match_jax_bf16(branches, which):
    i = ("kernel", "logits").index(which)
    port, jbf, jf = branches["port"][i], branches["bf16"][i], branches["f32"][i]
    own = _dist(jbf, jf)
    assert own > 0, "the JAX bf16 form drifts from f32"
    assert _dist(port, jbf) <= 2 * own, (_dist(port, jbf), own)
    assert _dist(port, jf) <= 3 * own


def test_parameters_stay_float32_and_compute_is_bf16(branches):
    net = branches["net"]
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(b.dtype == torch.float32 for b in net.buffers())
    x = torch.zeros(1, S, S, 3)
    with torch.no_grad():
        assert net.feature_extractor(x.permute(0, 3, 1, 2))["layer4"].dtype == torch.bfloat16


def test_mask_crop_matches_jax_bf16():
    frames, boxes = common.frame_sequence(2, seed=3)
    _, variables = common.jax_alpha_refine()
    spec = jax_ar.RefineSpec(input_sz=S, output_sz=S)
    masks = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        seg = jax_ar.ARcmSeg(variables, spec, dtype=dt)
        seg.initialize(frames[0], boxes[0])
        crop, _, _ = jax_ar.sample_target_se(frames[1], boxes[1], 2.0, S)
        masks[name] = np.asarray(seg._mask_jit(variables, seg._preprocess(crop), seg.kernel),
                                 np.float32)[0, :, :, 0]
    port = port_ar.ARcmSeg(common.port_alpha_refine(), dtype=torch.bfloat16)
    port.initialize(frames[0], boxes[0])
    got = port.mask_crop(frames[1], boxes[1])
    assert got.dtype == torch.float32
    own = _dist(masks["bf16"], masks["f32"])
    assert 0 < own and _dist(got.numpy(), masks["bf16"]) <= 2 * own
    full = port.get_mask(frames[1], boxes[1])
    assert full.shape == frames[1].shape[:2] and full.dtype == np.float32


def _jax_step_loss(jnet, variables, batch) -> float:
    """The loss `make_refine_train_step` reports: its loss_fn at the step's
    variables (the forward before the update), compiled without the
    gradient and the optimizer."""
    def loss(v, b):
        logits = jnet.apply(v, b["ref_images"], b["ref_boxes"], b["test_images"],
                            method=jnet.forward_train)
        target = b["test_masks"]
        if target.shape[1:3] != logits.shape[1:3]:
            target = (jax.image.resize(target, (target.shape[0],) + logits.shape[1:3] + (1,),
                                       "bilinear") > 0.5).astype(jnp.float32)
        return jax_refine.mask_losses(logits, target)[0]
    return float(jax.jit(loss)(variables, batch))


def test_refine_step_bf16_loss_matches_jax_bf16():
    """One AdamW step at bf16 compute on float32 leaves: the loss within
    2^-6 relative of JAX's bf16 step; the leaves stay float32."""
    net, variables = common.jax_alpha_refine(32)
    jnet = jax_ar.AlphaRefineNet(spec=net.spec, dtype=jnp.bfloat16)
    batch = jax_refine.batch_from_box_dataset(_samples(1), S, None)
    pnet = port_ar.set_refine_dtype(common.port_alpha_refine(32), torch.bfloat16)
    trainer = port_refine.RefineTrainer(pnet, lr=LR, weight_decay=WD)
    got = trainer.step(batch)
    want = _jax_step_loss(jnet, variables, batch)
    assert abs(got["loss"] - want) <= 2 ** -6 * abs(want), (got["loss"], want)
    assert all(t.dtype == torch.float32 for t in trainer.leaves)


def test_other_dtypes_raise():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        port_ar.build_alpha_refine(input_sz=S, output_sz=S, device="cpu", dtype=torch.float16)
    net = common.port_alpha_refine()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        port_ar.ARcmSeg(net, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        port_refine.build_refine_trainer(input_sz=S, device="cpu", dtype=torch.float16)
    built, _ = port_ar.build_alpha_refine(input_sz=S, output_sz=S, device="cpu",
                                          dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in built.parameters())
