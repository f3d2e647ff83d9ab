"""The port's learned DiMP / ATOM modules and their checkpoints
(multi_modal_tracking_torch/classic/dimpnet.py, the trackers'
load_network, utils/convert.py from_jax_variables on a classic tree) on
the CPU against the JAX package's classic/dimpnet.py and
utils/torch_convert.py:

  * each dimpnet module under a reference-keyed state dict (the torch
    oracles of tests/test_dimpnet_convert.py) loaded into both packages;
  * full DiMPnet / ATOMnet checkpoints (the reference's keys, layer4 and fc
    included) loading strictly into the JAX converter and the port's
    trackers, which then compute alike; a missing or an unknown key
    raising;
  * a JAX DiMP-50 variable tree through `from_jax_variables`.

Torch runs f32 on one intra-op thread (tests/torch_port_threads.py), JAX at
"highest" matmul precision (tests/conftest.py). Tolerances: 1e-4 of each
output's largest magnitude (convolutions, PrRoI and the ResNet's sums in
other orders); the IoU's box gradient 1e-3 of its largest magnitude. The
JAX variables are traced with jax.eval_shape and filled by the converter
or a numpy seed, and the JAX side runs jitted, so that few XLA programs
compile.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.classic import dimpnet as jD
from multi_modal_tracking_tpu.classic.common import combine_nets, split_nets

from multi_modal_tracking_torch.classic import build_classic_tracker
from multi_modal_tracking_torch.classic import dimpnet as D
from multi_modal_tracking_torch.utils.convert import from_jax_variables
from tests.test_dimpnet_convert import (AtomIoUNetOracle, FilterInitializerLinearOracle,
                                        SDGNOracle, _boxes, _convert, _dimp18_classifier_sd,
                                        _nhwc, _randomize_bn, _resnet18_sd, _sd,
                                        clf_features_oracle)
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FEAT_DIM, OUT_DIM, FS, STRIDE = 24, 16, 4, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want, rel=1e-4):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=rel * max(np.abs(want).max(), 1e-12))


def _port_sd(sd, prefix):
    """A reference state dict's entries under `prefix`, the prefix cut and
    the BatchNorm step counters dropped, as tensors."""
    return {k[len(prefix) + 1:]: torch.as_tensor(v) for k, v in sd.items()
            if k.startswith(prefix + ".") and not k.endswith("num_batches_tracked")}


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(3)


@pytest.mark.parametrize("num_blocks", [0, 1])
def test_clf_features(rng, num_blocks):
    """dimpnet50 (bare conv) and dimpnet18 (BasicBlock + conv) layouts."""
    oracle = clf_features_oracle(FEAT_DIM, OUT_DIM, num_blocks, FS).eval()
    _randomize_bn(oracle)
    x = torch.tensor(rng.standard_normal((2, FEAT_DIM, 9, 9)), dtype=torch.float32)
    sd = _sd(oracle, "classifier.feature_extractor")
    model = jD.ClfFeatures(FEAT_DIM, OUT_DIM, num_blocks=num_blocks, filter_size=FS)
    v = model.init(jax.random.PRNGKey(0), _nhwc(x))
    conv = _convert(sd, {c: {"classifier": {"feature_extractor": v[c]}} for c in v})
    want = model.apply({c: conv[c]["classifier"]["feature_extractor"] for c in conv}, _nhwc(x))
    port = D.ClfFeatures(FEAT_DIM, FEAT_DIM, OUT_DIM, num_blocks, FS)
    port.load_state_dict(_port_sd(sd, "classifier.feature_extractor"), strict=True)
    _rel(port(x).permute(0, 2, 3, 1), want)
    _rel(port(x), oracle(x).detach())


def test_filter_initializer_and_filter_ops(rng):
    oracle = FilterInitializerLinearOracle(FS, OUT_DIM, STRIDE).eval()
    feat = torch.tensor(rng.standard_normal((3, OUT_DIM, 9, 9)), dtype=torch.float32)
    bb = _boxes(rng, 3, hi=9 * STRIDE)
    sd = _sd(oracle, "classifier.filter_initializer")
    model = jD.FilterInitializerLinear(OUT_DIM, FS, STRIDE)
    v = model.init(jax.random.PRNGKey(0), _nhwc(feat), jnp.asarray(bb))
    conv = _convert(sd, {"params": {"classifier": {"filter_initializer": v["params"]}}})
    want = model.apply({"params": conv["params"]["classifier"]["filter_initializer"]},
                       _nhwc(feat), jnp.asarray(bb))                          # (fs, fs, C)
    port = D.FilterInitializerLinear(OUT_DIM, FS, STRIDE)
    port.load_state_dict(_port_sd(sd, "classifier.filter_initializer"), strict=True)
    w = port(feat, _t(bb))
    _rel(w.permute(1, 2, 0), want)
    # the correlation with the reference's even-filter padding, its exact
    # transpose, and the distance map
    scores = D.apply_filter(feat, w)
    jscores = jD.apply_filter(_nhwc(feat), want)
    assert scores.shape == (3, 10, 10)
    _rel(scores, jscores)
    res = torch.tensor(rng.standard_normal((3, 10, 10)), dtype=torch.float32)
    _rel(D.apply_feat_transpose(feat, res, tuple(w.shape)).permute(1, 2, 0),
         jD.apply_feat_transpose(_nhwc(feat), jnp.asarray(res.numpy()), (FS, FS, OUT_DIM)))
    c = rng.uniform(0, 9, (3, 2)).astype(np.float32)
    _rel(D.distance_map(_t(c), (10, 11), 5).permute(0, 2, 3, 1),
         jD.distance_map(jnp.asarray(c), (10, 11), 5))


def test_sd_gn_optimizer(rng):
    """Three unrolled SD-GN steps with randomised learned scalars and bin
    predictors, with and without sample weights; and the default init."""
    oracle = SDGNOracle(num_iter=3, feat_stride=STRIDE).eval()
    with torch.no_grad():
        oracle.log_step_length.fill_(-0.3)
        oracle.filter_reg.fill_(0.05)
        g = torch.Generator().manual_seed(11)
        oracle.label_map_predictor.weight.uniform_(0.0, 1.0, generator=g)
        oracle.target_mask_predictor[0].weight.uniform_(-2.0, 2.0, generator=g)
        oracle.spatial_weight_predictor.weight.uniform_(0.5, 1.5, generator=g)
    feat = torch.tensor(rng.standard_normal((3, OUT_DIM, 9, 9)), dtype=torch.float32)
    bb = torch.tensor(_boxes(rng, 3, hi=9 * STRIDE))
    w0 = torch.tensor(rng.standard_normal((OUT_DIM, FS, FS)) * 0.1, dtype=torch.float32)
    sw = torch.tensor(rng.uniform(0.2, 1.0, (3,)), dtype=torch.float32)
    sd = _sd(oracle, "classifier.filter_optimizer")
    model = jD.DiMPSteepestDescentGN(num_iter=3, feat_stride=STRIDE)
    args = (jnp.asarray(w0.numpy().transpose(1, 2, 0)), _nhwc(feat), jnp.asarray(bb.numpy()))
    v = model.init(jax.random.PRNGKey(0), *args, jnp.asarray(sw.numpy()))
    conv = _convert(sd, {"params": {"classifier": {"filter_optimizer": v["params"]}}})
    jv = {"params": conv["params"]["classifier"]["filter_optimizer"]}
    port = D.DiMPSteepestDescentGN(num_iter=3, feat_stride=STRIDE)
    port.load_state_dict(_port_sd(sd, "classifier.filter_optimizer"), strict=True)
    for weights in (sw, None):
        want = model.apply(jv, *args, None if weights is None else jnp.asarray(weights.numpy()))
        _rel(port(w0, feat, bb, weights).permute(1, 2, 0), want)
    fresh = D.DiMPSteepestDescentGN(num_iter=1)
    jfresh = jD.DiMPSteepestDescentGN(num_iter=1).init(
        jax.random.PRNGKey(0), jnp.zeros((FS, FS, 8)), jnp.zeros((1, 9, 9, 8)),
        jnp.asarray([[10.0, 10.0, 40.0, 40.0]]))["params"]
    for name, key in (("label_map_predictor", "label_map_predictor.weight"),
                      ("target_mask_predictor", "target_mask_predictor.0.weight"),
                      ("spatial_weight_predictor", "spatial_weight_predictor.weight")):
        _rel(fresh.state_dict()[key].reshape(-1), np.asarray(jfresh[name])[:, 0], 1e-6)
    _rel(fresh.log_step_length, jfresh["log_step_length"], 1e-6)
    _rel(fresh.filter_reg, jfresh["filter_reg"], 1e-6)


def test_atom_iou_net_and_its_box_gradient(rng):
    """Modulation, IoU features, IoU prediction and the IoU's gradient in
    the proposal boxes (what the refinement ascends)."""
    oracle = AtomIoUNetOracle().eval()
    _randomize_bn(oracle)
    B, P = 2, 3
    f3r, f3t = (torch.tensor(rng.standard_normal((B, 128, 8, 8)), dtype=torch.float32)
                for _ in range(2))
    f4r, f4t = (torch.tensor(rng.standard_normal((B, 256, 4, 4)), dtype=torch.float32)
                for _ in range(2))
    bb = torch.tensor(_boxes(rng, B, hi=60.0))
    prop = torch.tensor(np.stack([_boxes(rng, P, hi=60.0) for _ in range(B)]))
    sd = _sd(oracle, "bb_regressor")
    model = jD.AtomIoUNet(input_dim=(128, 256))
    jargs = (_nhwc(f3r), _nhwc(f4r), _nhwc(f3t), _nhwc(f4t), jnp.asarray(bb.numpy()),
             jnp.asarray(prop.numpy()))
    v = _jax_tree(model, *jargs)
    conv = _convert(sd, {c: {"bb_regressor": v[c]} for c in v})
    jv = {c: conv[c]["bb_regressor"] for c in conv}
    box = np.asarray([32.0, 31.0, 42.0, 43.0], np.float32)

    @jax.jit
    def jax_side(jv, jargs, box):
        jmod = model.apply(jv, jargs[0], jargs[1], jargs[4], method="get_modulation")
        jfeat = model.apply(jv, jargs[2], jargs[3], method="get_iou_feat")
        grad = jax.grad(lambda b: model.apply(jv, jmod, jfeat, b[None, None],
                                              method="predict_iou")[0, 0])(box)
        return (jmod, jfeat, model.apply(jv, jmod, jfeat, jargs[5], method="predict_iou"),
                model.apply(jv, *jargs), grad)

    jmod, jfeat, jiou, jfull, jg = jax_side(jv, jargs, jnp.asarray(box))
    port = D.AtomIoUNet((128, 256))
    port.load_state_dict(_port_sd(sd, "bb_regressor"), strict=True)
    mod = port.get_modulation(f3r, f4r, bb)
    for a, b in zip(mod, jmod):
        _rel(a, b)
    feat = port.get_iou_feat(f3t, f4t)
    for a, b in zip(feat, jfeat):
        _rel(a.permute(0, 2, 3, 1), b)
    _rel(port.predict_iou(mod, feat, prop), jiou)
    _rel(port(f3r, f4r, f3t, f4t, bb, prop), jfull)
    p = _t(box).requires_grad_(True)
    (g,) = torch.autograd.grad(port.predict_iou(mod, feat, p[None, None])[0, 0], p)
    _rel(g, jg, 1e-3)
    assert np.abs(_np(g)).max() > 0


def test_dimp_classifier_pipeline(rng):
    """features -> initializer -> SD-GN -> classify as one DiMPClassifier
    (the tracker's call pattern), both packages on one reference dict."""
    feats_o = clf_features_oracle(FEAT_DIM, OUT_DIM, 0, FS).eval()
    init_o = FilterInitializerLinearOracle(FS, OUT_DIM, STRIDE).eval()
    opt_o = SDGNOracle(num_iter=2, feat_stride=STRIDE).eval()
    sd = {**_sd(feats_o, "classifier.feature_extractor"),
          **_sd(init_o, "classifier.filter_initializer"),
          **_sd(opt_o, "classifier.filter_optimizer")}
    x = torch.tensor(rng.standard_normal((3, FEAT_DIM, 9, 9)), dtype=torch.float32)
    bb = _boxes(rng, 3, hi=9 * STRIDE)
    model = jD.DiMPClassifier(FEAT_DIM, OUT_DIM, num_blocks=0, filter_size=FS,
                              feat_stride=STRIDE, optim_iter=2)
    v = model.init(jax.random.PRNGKey(0), _nhwc(x), jnp.asarray(bb))
    conv = _convert(sd, {c: {"classifier": v[c]} for c in v})
    jv = {c: conv[c]["classifier"] for c in conv}
    port = D.DiMPClassifier(FEAT_DIM, FEAT_DIM, OUT_DIM, 0, FS, STRIDE, optim_iter=2)
    port.load_state_dict(_port_sd(sd, "classifier"), strict=True)
    _rel(port(x, _t(bb)), model.apply(jv, _nhwc(x), jnp.asarray(bb)))


# -------------------------------------------------------------- checkpoints
def _dimp18_sd():
    return {**_resnet18_sd("feature_extractor"), **_dimp18_classifier_sd(),
            **_sd(AtomIoUNetOracle().eval(), "bb_regressor")}


def _img():
    img = np.zeros((120, 160, 3), np.float32)
    img[40:70, 60:100] = 200.0
    img[50:60, 70:90] = 90.0
    return img


def _jax_tree(module, *args, seed=None, method=None):
    """A flax module's variables with the shapes `init` gives (a trace, no
    compile): zeros, or normal draws from `seed`."""
    shapes = jax.eval_shape(lambda r: module.init(r, *args, method=method),
                            jax.random.PRNGKey(0))
    rng = None if seed is None else np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32) if rng is None
        else rng.standard_normal(a.shape).astype(np.float32), shapes)


def _jax_nets(arch, sd=None, seed=None):
    """The JAX package's DiMPnet modules (arch resnet18 or resnet50) and
    their combined variables: from a reference state dict through
    torch_convert.convert_dimpnet (strict), or seeded."""
    from multi_modal_tracking_tpu.models import resnet as jres
    from multi_modal_tracking_tpu.utils.torch_convert import convert_dimpnet
    l3c, l2c, fdim, odim, nblocks = D.ARCH[arch]
    nets = {"backbone": getattr(jres, arch)(),
            "classifier": jD.DiMPClassifier(fdim, odim, nblocks, 4, 16, optim_iter=3),
            "bb_regressor": jD.AtomIoUNet(input_dim=(l2c, l3c))}
    l3, bb = jnp.zeros((1, 6, 6, l3c)), jnp.asarray([[20.0, 20.0, 40.0, 40.0]])
    args = {"backbone": (jnp.zeros((1, 96, 96, 3)),), "classifier": (l3, bb),
            "bb_regressor": (jnp.zeros((1, 12, 12, l2c)), l3, jnp.zeros((1, 12, 12, l2c)), l3,
                             bb, bb[:, None])}
    tree = combine_nets({k: _jax_tree(m, *args[k], seed=seed) for k, m in nets.items()})
    if sd is not None:
        tree, _ = convert_dimpnet(sd, tree, strict=True, verbose=False)
    return nets, split_nets(tree, list(nets)), tree


def _crop_batch():
    x = np.random.default_rng(13).uniform(0, 255, (2, 96, 96, 3)).astype(np.float32)
    from multi_modal_tracking_tpu.models.resnet import imagenet_preprocess
    from multi_modal_tracking_torch.ops.crop import normalize_imagenet
    return imagenet_preprocess(jnp.asarray(x)), normalize_imagenet(_t(x)).permute(0, 3, 1, 2)


def _check_loaded(nets, jv, net, with_classifier):
    """Backbone layer2 / layer3, the IoU net's modulation and IoU, and (DiMP)
    the classification features and the learned filter, port against JAX."""
    jx, px = _crop_batch()
    jf = jax.jit(nets["backbone"].apply)(jv["backbone"], jx)
    pf = net.feature_extractor(px, last="layer3")
    for k in ("layer2", "layer3"):
        _rel(pf[k].permute(0, 2, 3, 1), jf[k])
    bb = np.asarray([[30.0, 28.0, 36.0, 40.0], [25.0, 30.0, 44.0, 34.0]], np.float32)
    iou = nets["bb_regressor"]
    jmod = iou.apply(jv["bb_regressor"], jf["layer2"], jf["layer3"], jnp.asarray(bb),
                     method="get_modulation")
    mod = net.bb_regressor.get_modulation(pf["layer2"], pf["layer3"], _t(bb))
    for a, b in zip(mod, jmod):
        _rel(a, b)
    jfeat = iou.apply(jv["bb_regressor"], jf["layer2"], jf["layer3"], method="get_iou_feat")
    props = jnp.asarray(bb)[:, None] + jnp.asarray([[0.0, 0, 0, 0], [2, -1, 3, 1]])[None]
    _rel(net.bb_regressor.predict_iou(mod, net.bb_regressor.get_iou_feat(pf["layer2"],
                                                                          pf["layer3"]),
                                      _t(props)),
         iou.apply(jv["bb_regressor"], jmod, jfeat, props, method="predict_iou"))
    if with_classifier:
        clf = nets["classifier"]
        jc, jw = jax.jit(lambda v, x, b: (
            clf.apply(v, x, method="extract_classification_feat"),
            clf.apply(v, clf.apply(v, x, method="extract_classification_feat"), b, None, 3,
                      method="get_filter")))(jv["classifier"], jf["layer3"], jnp.asarray(bb))
        pc = net.classifier.extract_classification_feat(pf["layer3"])
        _rel(pc.permute(0, 2, 3, 1), jc)
        _rel(net.classifier.get_filter(pc, _t(bb), None, 3).permute(1, 2, 0), jw)


def test_dimpnet_checkpoint_loads_strictly():
    """A full dimpnet18-layout checkpoint (the reference's keys, layer4 and
    fc included) loads strictly into the JAX package's converter and into
    the port's tracker, and both compute alike; a missing or an unknown key
    raises."""
    sd = _dimp18_sd()
    nets, jv, _ = _jax_nets("resnet18", sd)
    pt = build_classic_tracker("dimp", device="cpu", crop_size=96)
    pt.load_network(sd)
    _check_loaded(nets, jv, pt.net, True)
    bad = dict(sd)
    bad.pop("classifier.filter_initializer.filter_conv.bias")
    with pytest.raises(ValueError, match="missing"):
        pt.load_network(bad)
    with pytest.raises(ValueError, match="unexpected"):
        pt.load_network({**sd, "classifier.extra.weight": np.zeros(3, np.float32)})


def test_load_backbone_takes_a_bare_resnet():
    """ECO's and ATOM's load_backbone: a torchvision-layout ResNet-18 dict
    (fc and layer4 included) into the trackers' backbones."""
    sd = {k.split(".", 1)[1]: v for k, v in _resnet18_sd("x").items()}
    for name, kw in (("eco", dict(features="conv1+layer3")), ("atom", {})):
        t = build_classic_tracker(name, device="cpu", crop_size=64, **kw)
        t.load_backbone(sd)
        for key in ("conv1.weight", "layer3.1.bn2.running_var", "layer2.0.downsample.0.weight"):
            np.testing.assert_array_equal(_np(t.backbone.state_dict()[key]), sd[key])


def test_atomnet_checkpoint_loads_strictly():
    """ATOMnet: feature_extractor + bb_regressor only."""
    sd = {**_resnet18_sd("feature_extractor"), **_sd(AtomIoUNetOracle().eval(), "bb_regressor")}
    nets, jv, _ = _jax_nets("resnet18")
    from multi_modal_tracking_tpu.utils.torch_convert import convert_dimpnet
    tree, _ = convert_dimpnet(sd, combine_nets({k: jv[k] for k in ("backbone", "bb_regressor")}),
                              strict=True, verbose=False)
    pt = build_classic_tracker("atom", device="cpu", crop_size=96)
    pt.load_network(sd)
    _check_loaded(nets, split_nets(tree, ["backbone", "bb_regressor"]), pt.net, False)
    with pytest.raises(ValueError, match="unexpected"):
        pt.load_network(_dimp18_sd())                       # a DiMPnet's classifier


def test_from_jax_variables_on_a_classic_tree():
    """A JAX DiMP-50 combined tree (backbone, classifier, bb_regressor)
    maps onto every tensor of the port's DiMPNet; only layer4, which the
    port does not build, is left over; the nets then compute alike."""
    nets, jv, tree = _jax_nets("resnet50", seed=5)
    # BatchNorm variances must be positive, kernels small
    tree = jax.tree_util.tree_map_with_path(
        lambda p, a: np.abs(a) + 0.5 if p[-1].key == "var" else
        0.05 * a if p[-1].key in ("kernel", "label_map_predictor") else a, tree)
    jv = split_nets(tree, list(nets))
    sd = from_jax_variables(tree)
    net = D.DiMPNet("resnet50")
    own = set(net.state_dict())
    assert own <= set(sd)
    assert {k for k in sd if k not in own} == {k for k in sd
                                               if k.startswith("feature_extractor.layer4.")}
    net.load_network(sd)
    w = tree["params"]["classifier"]["filter_optimizer"]["target_mask_predictor"]
    np.testing.assert_array_equal(
        _np(net.classifier.filter_optimizer.target_mask_predictor[0].weight).reshape(-1), w[:, 0])
    _check_loaded(nets, jv, net, True)
