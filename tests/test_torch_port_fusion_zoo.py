"""The port's fusion table (multi_modal_tracking_torch/models/fusion.py) and
its modulated deformable convolution (ops/deform_conv.py) against the JAX
package's, on the same weights and inputs, at a small size: modal maps
6x6 of 64 channels, encoder d_model 32 (head dim 4), 2 layers.

The port's weights are its `init_random` ones perturbed from a numpy seed
(so that the zero-initialised offset kernels act), and cross to the JAX
modules through the JAX package's own converter with strict=True: every
key of the port is a reference key that the converter maps onto a leaf,
and every leaf is filled. The way back, `from_jax_variables`, must give the
port's state dict again.

Tolerance: f32 on both sides (JAX at "highest" matmul precision), 1e-4
abs on outputs of order 1 (measured differences are ~1e-6). Gradients
(one attention fusion, one deform fusion, both deform-conv group counts):
1e-4 of each tensor's largest gradient, plus 1e-6 of the global norm for
gradients that are exactly zero on one side (conv outputs in front of a
training-mode BatchNorm).
"""
import jax
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.models import fusion as jax_fusion
from multi_modal_tracking_tpu.ops.deform_conv import \
    modulated_deform_conv2d as jax_deform_conv
from multi_modal_tracking_tpu.utils.torch_convert import convert_state_dict

from multi_modal_tracking_torch.models.build import init_random
from multi_modal_tracking_torch.models.fusion import FUSION_CLASSES, build_fusion
from multi_modal_tracking_torch.ops.deform_conv import modulated_deform_conv2d
from multi_modal_tracking_torch.utils.convert import from_jax_variables
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

C, D_MODEL, LAYERS, HW = 64, 32, 2, 6
ATOL = 1e-4
CONV_CLASSES = ("RGBT_Fusion_1", "RGBT_Fusion_2", "RGBT_Fusion_3", "RGBT_Fusion_Cat")


@pytest.fixture(scope="module", autouse=True)
def _jax_highest():
    """f32 matmuls in JAX."""
    with jax.default_matmul_precision("highest"):
        yield


def randomise_port(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Perturb every parameter and buffer of a port module from a numpy
    seed: parameters by 0.05 (matrices) or 0.1 normal noise, BN means
    uniform in +-0.2, variances in [0.6, 1.5]."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.6, 1.5, t.shape).astype(np.float32)))
            elif name.endswith("running_mean"):
                t.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, t.shape).astype(np.float32)))
            else:
                scale = 0.05 if t.dim() > 1 else 0.1
                t.add_(torch.from_numpy((scale * rng.standard_normal(t.shape))
                                        .astype(np.float32)))
    return module


def to_jax(port_sd, jax_vars, prefix: str):
    """The port's state dict under `prefix` -> the JAX variables of the same
    module through the JAX package's converter, strictly."""
    sd = {f"{prefix}.{k}": v.numpy() for k, v in port_sd.items()}
    target = {c: {prefix: t} for c, t in jax_vars.items()}
    out, report = convert_state_dict(sd, target, strict=True, verbose=False)
    assert not report["skipped"] and not report["missing"]
    return {c: t[prefix] for c, t in out.items()}


def _maps(seed, batch=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((batch, HW, HW, C)).astype(np.float32) for _ in range(2))


def _fusion_pair(cls, seed):
    x_v, x_i = _maps(seed)
    jf = jax_fusion.build_fusion(cls, C, D_MODEL, LAYERS)
    jvars = jax.jit(jf.init)(jax.random.PRNGKey(0), x_v, x_i)
    pf = randomise_port(init_random(build_fusion(cls, C, D_MODEL, LAYERS), seed), seed)
    return jf, to_jax(pf.state_dict(), dict(jvars), "fusion_vi"), pf.eval()


@pytest.fixture(scope="module")
def fusions():
    return {cls: _fusion_pair(cls, i) for i, cls in enumerate(FUSION_CLASSES)}


def test_table_is_the_jax_table():
    """Every FUSION_CLASS of the JAX package builds in the port, and nothing
    else does."""
    for cls in FUSION_CLASSES:
        jax_fusion.build_fusion(cls, C, D_MODEL, LAYERS)
    assert len(FUSION_CLASSES) == 11
    with pytest.raises(ValueError, match="FUSION_CLASS"):
        build_fusion("Attention_Fusion_Bogus", C, D_MODEL, LAYERS)


@pytest.mark.parametrize("cls", FUSION_CLASSES)
def test_fusion_matches_jax(fusions, cls):
    """Eval mode (BN on its running statistics): the fused map, and the
    weights back through from_jax_variables."""
    jf, jvars, pf = fusions[cls]
    x_v, x_i = _maps(20)
    want = np.asarray(jax.jit(lambda v, a, b: jf.apply(v, a, b))(jvars, x_v, x_i))
    with torch.no_grad():
        got = pf(torch.from_numpy(x_v), torch.from_numpy(x_i)).numpy()
    assert got.shape == want.shape == (2, HW, HW, C)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    back = from_jax_variables({c: {"fusion_vi": t} for c, t in jvars.items()})
    sd = pf.state_dict()
    assert back.keys() == {f"fusion_vi.{k}" for k in sd}
    for k, v in sd.items():
        torch.testing.assert_close(back[f"fusion_vi.{k}"], v, rtol=0, atol=0)


def _unprefixed(sd: dict) -> dict:
    return {k[len("fusion_vi."):]: v for k, v in sd.items()}


def _close_grads(got: dict, want: dict):
    total = np.sqrt(sum(float((w.astype(np.float64) ** 2).sum()) for w in want.values()))
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-6 * total,
                                   err_msg=name)


@pytest.mark.parametrize("cls", ["Attention_Fusion_Bimodal_2", "RGBT_Fusion_2"])
def test_fusion_gradients_match_jax(fusions, cls):
    """Training mode (BatchNorm on batch statistics, updating its running
    ones; no dropout): output, the gradients of every parameter and of both
    inputs under a fixed random projection of the output, and the running
    statistics after the step."""
    jf, jvars, _ = fusions[cls]
    pf = randomise_port(init_random(build_fusion(cls, C, D_MODEL, LAYERS, dropout=0.0), 1), 1)
    pf.load_state_dict(_unprefixed(from_jax_variables(
        {c: {"fusion_vi": t} for c, t in jvars.items()})), strict=True)
    pf.train()
    x_v, x_i = _maps(21)
    proj = np.random.default_rng(22).standard_normal((2, HW, HW, C)).astype(np.float32)

    def loss(params, stats, a, b):
        out, new = jf.apply({"params": params, **({"batch_stats": stats} if stats else {})},
                            a, b, True, train=True, mutable=["batch_stats"])
        return (out * proj).sum(), (out, new.get("batch_stats", {}))

    (gp, ga, gb), (out, stats) = jax.jit(jax.grad(loss, argnums=(0, 2, 3), has_aux=True))(
        jvars["params"], jvars.get("batch_stats", {}), x_v, x_i)
    tv, ti = (torch.from_numpy(x).requires_grad_() for x in (x_v, x_i))
    got = pf(tv, ti)
    (got * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=ATOL, rtol=0)
    want = {k: v.numpy() for k, v in
            from_jax_variables({"params": {"fusion_vi": jax.device_get(gp)}}).items()}
    want.update({"x_v": np.asarray(ga), "x_i": np.asarray(gb)})
    grads = {f"fusion_vi.{n}": p.grad.numpy() for n, p in pf.named_parameters()}
    grads.update({"x_v": tv.grad.numpy(), "x_i": ti.grad.numpy()})
    assert grads.keys() == want.keys()
    _close_grads(grads, want)
    if stats:
        buffers = dict(pf.named_buffers())
        for name, w in from_jax_variables({"batch_stats": {"fusion_vi": jax.device_get(stats)}}
                                          ).items():
            if not name.endswith("num_batches_tracked"):
                np.testing.assert_allclose(buffers[name[len("fusion_vi."):]].numpy(), w.numpy(),
                                           atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("dg", [1, 2])
def test_deform_conv_matches_jax(dg):
    """Forward and gradients of modulated_deform_conv2d with offsets up to
    4 pixels on a 7x9 map, so that many taps leave it (mmcv's zero border),
    some by less than a pixel (one corner inside)."""
    rng = np.random.default_rng(dg)
    B, H, W, cin, cout = 2, 7, 9, 8, 6
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    off = rng.uniform(-4.0, 4.0, (B, H, W, dg * 9 * 2)).astype(np.float32)
    mask = rng.uniform(0.0, 1.0, (B, H, W, dg * 9)).astype(np.float32)
    w = (0.2 * rng.standard_normal((cout, cin, 3, 3))).astype(np.float32)
    proj = rng.standard_normal((B, H, W, cout)).astype(np.float32)
    w_hwio = np.ascontiguousarray(w.transpose(2, 3, 1, 0))

    def loss(*args):
        out = jax_deform_conv(*args, deform_groups=dg, padding=1)
        return (out * proj).sum(), out

    grads, want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
        x, off, mask, w_hwio)
    tens = [torch.from_numpy(a).requires_grad_() for a in (x, off, mask, w)]
    got = modulated_deform_conv2d(*tens, deform_groups=dg, padding=1)
    (got * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    g = dict(zip(("x", "offset", "mask", "weight"), (t.grad.numpy() for t in tens)))
    wg = dict(zip(("x", "offset", "mask", "weight"), (np.asarray(a) for a in grads)))
    wg["weight"] = wg["weight"].transpose(3, 2, 0, 1)
    _close_grads(g, wg)
    outside = np.abs(off).max() > 3.0 and (np.abs(off) > 1.0).mean() > 0.5
    assert outside, "offsets that leave the map"


def test_deform_conv_returns_input_dtype_and_zero_outside():
    """bf16 in, bf16 out (computed in f32); a tap whose four corners all lie
    outside the map samples zero."""
    x = torch.randn(1, 4, 4, 2, dtype=torch.bfloat16)
    w = torch.randn(3, 2, 3, 3)
    off = torch.full((1, 4, 4, 18), 10.0)
    mask = torch.ones(1, 4, 4, 9)
    out = modulated_deform_conv2d(x, off, mask, w)
    assert out.dtype == torch.bfloat16 and bool((out == 0).all())


@pytest.mark.parametrize("cls", CONV_CLASSES)
def test_conv_fusion_init(cls):
    """init_random gives the deform fusions the JAX init (zero offset
    convolution, he-normal deformable kernel: deviation sqrt(2 / fan_in)
    truncated at two deviations) and every BN unit scale, zero shift."""
    pf = init_random(build_fusion(cls, C, D_MODEL, LAYERS), 0)
    sd = pf.state_dict()
    for k, v in sd.items():
        if "offset" in k:
            assert not bool(v.any()), k
        if k.endswith("_bn.weight"):
            assert bool((v == 1).all()), k
    if cls in ("RGBT_Fusion_2", "RGBT_Fusion_3"):
        w = sd["fusion.weight"]
        std = float(np.sqrt(2.0 / w[0].numel()))
        assert float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6
        assert 0.7 * std < float(w.std()) < 1.3 * std
