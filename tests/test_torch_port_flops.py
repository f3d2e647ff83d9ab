"""The port's matmul+conv FLOP counter (multi_modal_tracking_torch.utils.flops)
against the JAX package's jaxpr walker (multi_modal_tracking_tpu.utils.flops).

Both count shapes only: the JAX side walks `jax.make_jaxpr` of the function
on `jax.eval_shape` variables (abstract: no compile, no arithmetic), the port
runs the model on the meta device (and once on CPU tensors, which must give
the same count). The counts are exact, forward and train step: the products
that the two packages compute differently are added by formula on the port's
side (mixed attention, MSDA's dense einsums, CE's one-hot row products; see
the counter's module docstring), so no term remains; the tests name each
such term by op in `by_op` and check its formula.

`python tests/test_torch_port_flops.py --full` prints both packages' counts
at full width: the flagship's forward at batch 1 (keep 0.7, and the
recipe's keep) and its train step at batch 16, keep 0.7 (about 30 s of
abstract tracing on the CPU).
"""
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as
from multi_modal_tracking_tpu.models import convmae as jax_cm
from multi_modal_tracking_tpu.models import cvt as jax_cvt
from multi_modal_tracking_tpu.models import mixformer as jax_mf
from multi_modal_tracking_tpu.train.losses import box_losses as jax_box_losses
from multi_modal_tracking_tpu.utils.flops import matmul_conv_flops as jax_flops

from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.models import convmae as port_cm
from multi_modal_tracking_torch.models import cvt as port_cvt
from multi_modal_tracking_torch.models import mixformer as port_mf
from multi_modal_tracking_torch.models.layers import skip_default_init
from multi_modal_tracking_torch.ops.attention import mixed_attention
from multi_modal_tracking_torch.ops.msda import ms_deform_attn
from multi_modal_tracking_torch.train.losses import box_losses
from multi_modal_tracking_torch.utils.flops import matmul_conv_flops
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

T_SZ, S_SZ = 112, 176
FLAGSHIP = dict(search_size=S_SZ, template_size=T_SZ, embed_dim=64, depth=4, num_heads=4,
                head_type="CORNER_UP", head_dim=64,
                fusion_class="Attention_Fusion_Bimodal_LNSpecific", fusion_layers=2,
                ce_loc=(1, 3), ce_keep_ratio=(0.7, 0.7))
U_T, U_S = 32, 64
VIT = dict(search_size=U_S, template_size=U_T, embed_dim=64, depth=2, num_heads=4,
           head_type="CORNER_UP", head_dim=64)
CVT = dict(search_size=U_S, template_size=U_T, dim_embed=(16, 32, 64), num_heads=(1, 2, 4),
           depth=(1, 1, 2), head_dim=64)
CONVMAE = dict(search_size=U_S, template_size=U_T, embed_dim=(32, 48, 64), depth=(1, 1, 2),
               num_heads=4, head_type="CORNER_UP", head_dim=64)
#: family -> (JAX module, port module, (template, search) size, batch rows)
FAMILIES = {
    "asymmetric_shared_ce": (lambda: jax_as.MixFormerRGBT(spec=jax_as.RGBTSpec(**FLAGSHIP)),
                             lambda: port_as.MixFormerRGBT(port_as.RGBTSpec(
                                 **FLAGSHIP, drop_path_rate=0.0, fusion_dropout=0.0)),
                             (T_SZ, S_SZ), 2),
    "mixformer_vit": (lambda: jax_mf.MixFormer(spec=jax_mf.ViTSpec(**VIT)),
                      lambda: port_mf.MixFormer(port_mf.ViTSpec(**VIT)), (U_T, U_S), 1),
    "mixformer_cvt": (lambda: jax_cvt.MixFormerCvT(spec=jax_cvt.CvTSpec(**CVT)),
                      lambda: port_cvt.MixFormerCvT(port_cvt.CvTSpec(**CVT)), (U_T, U_S), 1),
    "mixformer_convmae": (lambda: jax_cm.MixFormerConvMAE(spec=jax_cm.ConvMAESpec(**CONVMAE)),
                          lambda: port_cm.MixFormerConvMAE(port_cm.ConvMAESpec(**CONVMAE)),
                          (U_T, U_S), 1),
}


def _abstract(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _port_model(make, device="meta", train=False):
    """The port model with uninitialised weights (the count reads shapes
    only) on `device`."""
    with skip_default_init():
        m = make()
    m = m.train() if train else m.eval()
    if device == "cpu":
        for p in m.parameters():
            torch.nn.init.normal_(p, 0.0, 0.02)
    return m.to(device)


def jax_forward_flops(jm, t_sz, s_sz, rows, keep=None):
    t, s = _abstract(rows, t_sz, t_sz, 3), _abstract(rows, s_sz, s_sz, 3)
    variables = jax.eval_shape(jm.init, jax.random.PRNGKey(0), t, t, s)
    extra = () if keep is None else (keep,)
    return jax_flops(lambda v, a, b, c: jm.apply(v, a, b, c, *extra)["pred_boxes"],
                     variables, t, t, s)


def port_forward_flops(pm, t_sz, s_sz, rows, keep=None, device="meta", by_op=None):
    t = torch.zeros(rows, t_sz, t_sz, 3, device=device)
    s = torch.zeros(rows, s_sz, s_sz, 3, device=device)
    extra = () if keep is None else (keep,)
    with torch.no_grad():
        return matmul_conv_flops(lambda: pm(t, t, s, *extra), by_op=by_op)


def jax_step_flops(jm, t_sz, s_sz, B, keep):
    """jax.grad of the flagship's box loss (make_train_step's loss_fn with
    dropout off; the optimizer update has no product)."""
    t, s = _abstract(2 * B, t_sz, t_sz, 3), _abstract(2 * B, s_sz, s_sz, 3)
    variables = jax.eval_shape(jm.init, jax.random.PRNGKey(0), t, t, s)

    def loss_fn(params, bs, a, b, c, gt):
        out, _ = jm.apply({"params": params, "batch_stats": bs}, a, b, c, keep,
                          deterministic=True, train=True, mutable=["batch_stats"])
        return jax_box_losses(out["pred_boxes"], gt, 2.0, 5.0)[0]
    return jax_flops(jax.grad(loss_fn), variables["params"], variables["batch_stats"],
                     t, t, s, _abstract(B, 4))


def port_step_flops(pm, t_sz, s_sz, B, keep, device="meta", by_op=None):
    t = torch.zeros(2 * B, t_sz, t_sz, 3, device=device)
    s = torch.zeros(2 * B, s_sz, s_sz, 3, device=device)
    gt = torch.tensor([[0.3, 0.3, 0.2, 0.2]] * B, device=device)

    def step():
        loss, _ = box_losses(pm(t, t, s, keep)["pred_boxes"], gt, 2.0, 5.0)
        loss.backward()
    return matmul_conv_flops(step, by_op=by_op)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_count_equals_jax(family):
    make_j, make_p, (t_sz, s_sz), rows = FAMILIES[family]
    keep = 0.7 if family == "asymmetric_shared_ce" else None
    want = jax_forward_flops(make_j(), t_sz, s_sz, rows, keep)
    got = port_forward_flops(_port_model(make_p), t_sz, s_sz, rows, keep)
    assert want > 0 and got == want


def test_train_step_count_equals_jax():
    """The flagship's forward + backward at batch 2, keep 0.7: exact. The
    terms that the port adds by formula, by op: the attention's and MSDA's
    einsums forward and backward, CE's one-hot products forward and
    backward; the rest is PyTorch's own mm/addmm/bmm/convolution(_backward)."""
    make_j, make_p, (t_sz, s_sz), _ = FAMILIES["asymmetric_shared_ce"]
    want = jax_step_flops(make_j(), t_sz, s_sz, 2, 0.7)
    by_op = {}
    got = port_step_flops(_port_model(make_p, train=True), t_sz, s_sz, 2, 0.7, by_op=by_op)
    assert got == want
    assert {"mixed_attention", "mixed_attention_bwd", "ms_deform_attn", "ms_deform_attn_bwd",
            "one_hot_rows", "one_hot_rows_bwd", "convolution", "convolution_backward"} <= set(by_op)
    assert by_op["mixed_attention_bwd"] == 2 * by_op["mixed_attention"]
    assert by_op["one_hot_rows_bwd"] == by_op["one_hot_rows"]
    assert by_op["ms_deform_attn_bwd"] == 2 * by_op["ms_deform_attn"]


def test_meta_and_cpu_counts_agree():
    _, make_p, (t_sz, s_sz), rows = FAMILIES["asymmetric_shared_ce"]
    meta = port_forward_flops(_port_model(make_p), t_sz, s_sz, rows, 0.7)
    cpu = port_forward_flops(_port_model(make_p, "cpu"), t_sz, s_sz, rows, 0.7, device="cpu")
    assert meta == cpu > 0
    meta_step = port_step_flops(_port_model(make_p, train=True), t_sz, s_sz, 1, 0.7)
    cpu_step = port_step_flops(_port_model(make_p, "cpu", train=True), t_sz, s_sz, 1, 0.7,
                               device="cpu")
    assert meta_step == cpu_step > 0


def _jax_and_port(jfn, pfn, *shapes):
    """One op's count both ways on zero inputs of `shapes`."""
    want = jax_flops(jfn, *(jnp.zeros(s, jnp.float32) for s in shapes))
    xs = [torch.zeros(s, requires_grad=True) for s in shapes]
    return want, matmul_conv_flops(lambda: pfn(*xs))


def _jconv(x, w, stride=1, groups=1):
    return jax.lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                        dimension_numbers=("NCHW", "OIHW", "NCHW"),
                                        feature_group_count=groups)


def _pconv(x, w, stride=1, groups=1):
    k = w.shape[-1]
    return torch.nn.functional.conv2d(x, w, stride=stride, padding=(k - 1) // 2, groups=groups)


OPS = {
    "linear_3d": (lambda x, w: x @ w.T, lambda x, w: torch.nn.functional.linear(x, w),
                  (2, 5, 8), (6, 8)),
    "batched_einsum": (lambda a, b: jnp.einsum("bhqd,bhkd->bhqk", a, b),
                       lambda a, b: torch.matmul(a, b.transpose(-2, -1)), (2, 3, 5, 4), (2, 3, 7, 4)),
    "conv_stride_1": (_jconv, _pconv, (2, 3, 8, 8), (4, 3, 3, 3)),
    "conv_depthwise": (lambda x, w: _jconv(x, w, groups=4), lambda x, w: _pconv(x, w, groups=4),
                       (2, 4, 8, 8), (4, 1, 3, 3)),
    "conv_grad_stride_1": (lambda x, w: jax.grad(lambda a, b: _jconv(a, b).sum(), (0, 1))(x, w),
                           lambda x, w: _pconv(x, w).sum().backward(), (2, 3, 8, 8), (4, 3, 3, 3)),
    "conv_grad_depthwise": (
        lambda x, w: jax.grad(lambda a, b: _jconv(a, b, groups=4).sum(), (0, 1))(x, w),
        lambda x, w: _pconv(x, w, groups=4).sum().backward(), (8, 4, 8, 8), (4, 1, 3, 3)),
    "matmul_grad": (lambda a, b: jax.grad(lambda p, q: (p @ q).sum(), (0, 1))(a, b),
                    lambda a, b: (a @ b).sum().backward(), (6, 5), (5, 7)),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_counts_equal_jax(op):
    jfn, pfn, *shapes = OPS[op]
    want, got = _jax_and_port(jfn, pfn, *shapes)
    assert want > 0 and got == want


def test_strided_conv_input_gradient_counts_the_input_pixels():
    """A stride-2 convolution's input gradient is JAX's input-dilated
    convolution, over the input's pixels: 4x the forward here."""
    def jfn(x, w):
        return jax.grad(lambda a, b: jax.lax.conv_general_dilated(
            a, b, (2, 2), "VALID", dimension_numbers=("NCHW", "OIHW", "NCHW")).sum(), (0, 1))(x, w)

    def pfn(x, w):
        torch.nn.functional.conv2d(x, w, stride=2).sum().backward()
    want, got = _jax_and_port(jfn, pfn, (2, 3, 8, 8), (4, 3, 2, 2))
    fwd = 2 * 2 * 16 * 4 * 3 * 4
    assert got == want == fwd * (1 + 1 + 4)


def test_kernel_terms_by_formula():
    """The kernels' JAX terms on their own: mixed attention (2 einsums of
    n_mt^2 + n_s * Nk rows x keys) and MSDA's dense levels (P + D per pixel
    of each level of at most 4096 pixels; a larger level gathers and counts
    0), forward and backward."""
    B, H, D, n_mt, Nq, Nk = 2, 3, 8, 4, 10, 14
    q = torch.zeros(B, H, Nq, D, requires_grad=True)
    k = torch.zeros(B, H, Nk, D, requires_grad=True)
    v = torch.zeros(B, H, Nk, D, requires_grad=True)
    by = {}
    matmul_conv_flops(lambda: mixed_attention(q, k, v, n_mt, 0.5).sum().backward(), by_op=by)
    one = 2 * B * H * D * (n_mt * n_mt + (Nq - n_mt) * Nk)
    assert by == {"mixed_attention": 2 * one, "mixed_attention_bwd": 4 * one}
    Bm, Lq, M, Dm, P, shapes = 1, 5, 2, 4, 3, ((4, 4), (65, 64))
    value = torch.zeros(Bm, sum(h * w for h, w in shapes), M, Dm, requires_grad=True)
    loc = torch.full((Bm, Lq, M, len(shapes), P, 2), 0.5, requires_grad=True)
    attw = torch.zeros(Bm, Lq, M, len(shapes), P, requires_grad=True)
    by = {}
    matmul_conv_flops(lambda: ms_deform_attn(value, shapes, loc, attw).sum().backward(),
                      by_op=by)
    e1, e2 = 2 * Bm * Lq * M * P * 16, 2 * Bm * M * Lq * 16 * Dm
    assert by == {"ms_deform_attn": e1 + e2, "ms_deform_attn_bwd": 2 * (e1 + e2)}


def test_no_count_outside_and_no_nesting():
    x = torch.zeros(3, 3)
    assert matmul_conv_flops(lambda: x @ x) == 2 * 27
    with pytest.raises(RuntimeError, match="already running"):
        matmul_conv_flops(lambda: matmul_conv_flops(lambda: x @ x))
    assert matmul_conv_flops(lambda: x @ x) == 54


def full_width_counts():
    """Both packages' counts of the flagship at full width (the recipe's
    geometry): forward at batch 1 at keep 0.7 and at the recipe's keep
    (no keep rate), train step at batch 16, keep 0.7; and the forward of
    the script's default config, what profile_model profiles."""
    from multi_modal_tracking_tpu.config import get_default_config as jax_cfg
    from multi_modal_tracking_torch.config import get_default_config
    recipe = "experiments/asymmetric_shared_ce/attention_lasher_newfusion_2layer.yaml"
    jc, pc = jax_cfg("asymmetric_shared_ce"), get_default_config("asymmetric_shared_ce")
    jc.update_from_file(recipe)
    pc.update_from_file(recipe)
    jm = jax_as.MixFormerRGBT(spec=jax_as.RGBTSpec.from_cfg(jc))
    make_p = lambda: port_as.build_mixformer_rgbt(pc, drop_path_rate=0.0, fusion_dropout=0.0)
    t_sz, s_sz = pc.DATA.TEMPLATE.SIZE, pc.DATA.SEARCH.SIZE
    out = {"forward_b1": (jax_forward_flops(jm, t_sz, s_sz, 2, 0.7),
                          port_forward_flops(_port_model(make_p), t_sz, s_sz, 2, 0.7)),
           "forward_b1_recipe_keep": (jax_forward_flops(jm, t_sz, s_sz, 2),
                                      port_forward_flops(_port_model(make_p), t_sz, s_sz, 2)),
           "train_step_b16": (jax_step_flops(jm, t_sz, s_sz, 16, 0.7),
                              port_step_flops(_port_model(make_p, train=True), t_sz, s_sz, 16,
                                              0.7))}
    # what profile_model profiles: the script's default config, no recipe
    jd, pd = jax_cfg("asymmetric_shared_ce"), get_default_config("asymmetric_shared_ce")
    jmd = jax_as.MixFormerRGBT(spec=jax_as.RGBTSpec.from_cfg(jd))
    make_d = lambda: port_as.build_mixformer_rgbt(pd)
    t_d, s_d = pd.DATA.TEMPLATE.SIZE, pd.DATA.SEARCH.SIZE
    out["profile_model_default_config"] = (jax_forward_flops(jmd, t_d, s_d, 2),
                                           port_forward_flops(_port_model(make_d), t_d, s_d, 2))
    for name, (j, p) in out.items():
        print(f"{name}: jax {j:.0f} port {p:.0f} ({p / 1e9:.3f} GFLOP, "
              f"port - jax {p - j:.0f})")
    return out


if __name__ == "__main__":
    if sys.argv[1:] != ["--full"]:
        raise SystemExit("usage: python tests/test_torch_port_flops.py --full")
    jax.config.update("jax_platforms", "cpu")
    full_width_counts()
