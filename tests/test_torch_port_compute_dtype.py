"""The compute dtype of the port's models (models/layers.py), which bf16
training runs on float32 parameters, as flax modules at dtype=bf16 with
param_dtype=float32:
  * Linear and Conv2d cast input, weight and bias to bf16 at every call; a
    weight used twice gets the f32 sum of its two bf16 gradients;
  * LayerNorm, GroupNorm and BatchNorm apply their f32 scale and bias in
    f32 and round once; BatchNorm's running statistics stay f32;
  * dropout and drop path divide by the keep probability in bf16, as the
    JAX package's `x / keep` does (models/layers.py:63);
  * the bf16 serving path (parameters cast to bf16) computes bit for bit as
    the modules' own PyTorch forwards, the code the serving path ran
    before the compute dtype existed;
  * `set_precision(bf16)` turns off cuBLAS's bf16 split-K reduction.
"""
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.models import layers
from multi_modal_tracking_torch.utils.checkpoint import cast_floating
from multi_modal_tracking_torch.utils.device import set_precision
from tests.test_torch_port_model import GEOM, S_SZ, T_SZ
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

BF16 = torch.bfloat16


def _x(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def test_linear_and_conv_cast_at_use_and_sum_weight_grads_in_f32():
    lin = layers.Linear(16, 8)
    lin.compute_dtype = BF16
    x1, x2 = _x(5, 16, seed=1).requires_grad_(), _x(3, 16, seed=2)
    y1, y2 = lin(x1), lin(x2)
    w, b = lin.weight.detach(), lin.bias.detach()
    assert y1.dtype == BF16 and lin.weight.dtype == torch.float32
    assert torch.equal(y1, nn.functional.linear(x1.detach().to(BF16), w.to(BF16), b.to(BF16)))
    g1, g2 = _x(5, 8, seed=3).to(BF16), _x(3, 8, seed=4).to(BF16)
    (y1 * g1).float().sum().backward(retain_graph=True)
    (y2 * g2).float().sum().backward()
    assert lin.weight.grad.dtype == torch.float32 and x1.grad.dtype == torch.float32
    want = (g1.t() @ x1.detach().to(BF16)).float() + (g2.t() @ x2.to(BF16)).float()
    torch.testing.assert_close(lin.weight.grad, want, rtol=2 ** -7, atol=1e-6)
    conv = layers.Conv2d(3, 4, kernel_size=2, stride=2)
    conv.compute_dtype = BF16
    xi = _x(1, 3, 8, 8, seed=5)
    assert torch.equal(conv(xi), nn.functional.conv2d(
        xi.to(BF16), conv.weight.detach().to(BF16), conv.bias.detach().to(BF16), stride=2))
    layers.set_compute_dtype(conv, None)
    assert conv(xi).dtype == torch.float32


def test_norms_apply_the_f32_affine_and_round_once():
    x = _x(2, 6, 32, seed=6).to(BF16)
    ln = layers.LayerNorm(32, eps=1e-6)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.1 * _x(32, seed=7))
        ln.bias.copy_(0.1 * _x(32, seed=8))
    want = nn.functional.layer_norm(x.float(), (32,), ln.weight, ln.bias, 1e-6).to(BF16)
    assert torch.equal(ln(x), want)
    gn = layers.GroupNorm(4, 32)
    xg = x.reshape(2, 32, 2, 3)
    assert torch.equal(gn(xg), nn.functional.group_norm(xg.float(), 4, gn.weight, gn.bias,
                                                         1e-5).to(BF16))
    bn = layers.BatchNorm2d(32).train()
    bn_f32 = layers.BatchNorm2d(32).train()
    y = bn(xg)
    want = bn_f32(xg.float())
    assert y.dtype == BF16 and torch.equal(y, want.detach().to(BF16))
    assert bn.running_var.dtype == torch.float32
    assert torch.equal(bn.running_var, bn_f32.running_var)
    assert torch.equal(bn.running_mean, bn_f32.running_mean)


def test_random_layers_divide_by_keep_in_bf16():
    """JAX's `x / keep` on bf16 x takes keep as bf16 (a weakly typed Python
    float); the kept values equal it bit for bit."""
    x = _x(64, 5, 7, seed=9).to(BF16)
    for cls in (layers.DropPath, layers.Dropout):
        layer = cls(0.1).train()
        layers.set_generator(layer, torch.Generator().manual_seed(3))
        y = layer(x)
        kept = y != 0
        want = np.asarray((jnp.asarray(x.float().numpy(), jnp.bfloat16) / 0.9)
                          .astype(jnp.float32))
        assert y.dtype == BF16
        assert np.array_equal(y.float().numpy()[kept.numpy()], want[kept.numpy()])


def _pr7_forwards(monkeypatch):
    """The modules' own PyTorch forwards, and the patch embedding casting the
    crops to the weight's dtype."""
    for cls, base in ((layers.Linear, nn.Linear), (layers.Conv2d, nn.Conv2d),
                      (layers.LayerNorm, nn.LayerNorm), (layers.GroupNorm, nn.GroupNorm)):
        monkeypatch.setattr(cls, "forward", base.forward)

    def patch_embed(self, x):
        x = self.proj(x.permute(0, 3, 1, 2).to(self.proj.weight.dtype))
        return x.flatten(2).transpose(1, 2)
    monkeypatch.setattr(layers.PatchEmbed, "forward", patch_embed)


def test_serving_path_is_bit_identical(monkeypatch):
    """A model whose parameters are cast to bf16 and that computes in bf16
    gives, bit for bit, the outputs of the same model run through the
    modules' own forwards: the cast-at-use is a no-op on bf16 parameters."""
    model = port_as.MixFormerRGBT(port_as.RGBTSpec(**GEOM))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    model = cast_floating(layers.set_compute_dtype(model, BF16), BF16).eval()
    t, ot = _x(2, T_SZ, T_SZ, 3, seed=10), _x(2, T_SZ, T_SZ, 3, seed=11)
    s = _x(2, S_SZ, S_SZ, 3, seed=12)
    outs = []
    with torch.no_grad():
        for patch in (False, True):
            if patch:
                _pr7_forwards(monkeypatch)
            cache = model.set_online(t, ot)
            outs.append((model(t, ot, s)["pred_boxes"],
                         model.forward_track(cache, s)["pred_boxes"]))
    for a, b in zip(*outs):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_set_precision_bf16_turns_off_reduced_precision_reduction():
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
        set_precision(torch.float32)
        assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        set_precision(BF16)
        assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
