"""The port's Alpha-Refine (models/resnet.py, models/alpha_refine.py) on the
CPU against the JAX package's, at input 64 with 64 x 64 masks: ResNet-18
and ResNet-50 features, the reference kernel and the mask logits, the
bilinear and bicubic resizes alone at odd sizes, the SE crops and
map_mask_back, ARcmSeg; and the reference-named torch oracle of
tests/test_alpha_refine_convert.py loading strictly into the port.

The JAX variables are seeded (tests/torch_port_alpha_refine_common.py)
and cross to the port through `from_jax_variables` (strict). Torch runs
f32 on one intra-op thread (tests/torch_port_threads.py), JAX at "highest"
matmul precision (tests/conftest.py).

Tolerances:
  * features, kernel and mask logits: 1e-4 of each tensor's largest
    magnitude (the sums of ResNet-50 round in other orders);
  * `_interp` and `pyr_up_bicubic` 1e-5 on values of order 1 (a few f32
    products and sums; JAX normalises its resize weights by their sum);
  * uint8 SE crops bit for bit (cv2 on the JAX side), float crops and
    map_mask_back 1e-5 (cv2's float path computes in double);
  * ARcmSeg's sigmoid masks 2e-3: with random weights the logits reach
    hundreds, so their 1e-4 of the largest magnitude moves a sigmoid near
    0.5 by up to ~1e-2 x 0.25; the 0.6 thresholds differ on at most 0.1%
    of the frame's pixels;
  * the torch oracle's logits 5e-4 (its convolutions are PyTorch's too,
    but its BatchNorm runs in eval mode with other rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.models import alpha_refine as jax_ar
from multi_modal_tracking_tpu.models import resnet as jax_resnet

from multi_modal_tracking_torch.models import alpha_refine as port_ar
from multi_modal_tracking_torch.models import resnet as port_resnet
from multi_modal_tracking_torch.utils.checkpoint import load_variables
from multi_modal_tracking_torch.utils.convert import from_jax_variables

from tests import torch_port_alpha_refine_common as common
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

S = common.INPUT_SZ


def _close(got, want, frac=1e-4, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=frac * float(np.abs(want).max()), err_msg=what)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


@pytest.fixture(scope="module")
def jax_side():
    """One JAX program: the seg features of the reference crops, the
    reference kernel and the test crops' mask logits, batch 2."""
    net, variables = common.jax_alpha_refine()
    rng = np.random.default_rng(0)
    p_ref = rng.standard_normal((2, S, S, 3)).astype(np.float32)
    p_test = rng.standard_normal((2, S, S, 3)).astype(np.float32)
    boxes = np.asarray([[16.0, 16.0, 32.0, 32.0], [20.0, 12.0, 24.0, 30.0]], np.float32)

    def run(v, pr, b, pt):
        bound = net.bind(v)
        feats = jax_resnet.seg_features(bound.feature_extractor(pr))
        kernel = bound.init_ref(pr, b)
        return feats, kernel, bound(pt, kernel)

    feats, kernel, logits = jax.jit(run)(variables, p_ref, boxes, p_test)
    return dict(p_ref=p_ref, p_test=p_test, boxes=boxes, feats=jax.device_get(feats),
                kernel=np.asarray(kernel), logits=np.asarray(logits))


@pytest.fixture(scope="module")
def port_net():
    return common.port_alpha_refine()


# ------------------------------------------------------------------ network
@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_features_match_jax(arch, jax_side, port_net):
    """ResNet-18 alone (a bare ResNet tree through from_jax_variables) and
    ResNet-50 as AR's backbone, every seg level."""
    if arch == "resnet50":
        with torch.no_grad():
            got = port_resnet.seg_features(port_net.feature_extractor(_nchw(jax_side["p_ref"])))
        want = jax_side["feats"]
    else:
        jnet = jax_resnet.resnet18()
        x = np.random.default_rng(3).standard_normal((1, 48, 40, 3)).astype(np.float32)
        variables = common.seeded_variables(jnet, 3, jnp.zeros_like(x))
        want = jax_resnet.seg_features(jax.jit(jnet.apply)(variables, x))
        net = port_resnet.resnet18().eval()
        net.load_state_dict(from_jax_variables(variables), strict=True)
        with torch.no_grad():
            got = port_resnet.seg_features(net(_nchw(x)))
    for level in ("layer1", "layer2", "layer3", "layer4", "layer5"):
        _close(got[level].permute(0, 2, 3, 1).numpy(), want[level], what=level)


def test_kernel_and_logits_match_jax(jax_side, port_net):
    """init_ref's kernel (B, p, p, 1024) and the mask logits (B, 64, 64, 1),
    the cached split against forward_train inside the port."""
    t = lambda k: torch.from_numpy(jax_side[k])
    with torch.no_grad():
        kernel = port_net.init_ref(t("p_ref"), t("boxes"))
        logits = port_net(t("p_test"), kernel)
        joint = port_net.forward_train(t("p_ref"), t("boxes"), t("p_test"))
    assert kernel.shape == (2, 8, 8, 1024) and logits.shape == (2, S, S, 1)
    _close(kernel.numpy(), jax_side["kernel"], what="kernel")
    _close(logits.numpy(), jax_side["logits"], what="logits")
    torch.testing.assert_close(joint, logits, rtol=0, atol=0)
    # the kernel matters: another box's kernel moves the logits
    with torch.no_grad():
        other = port_net(t("p_test"), kernel.flip(0))
    assert (other - logits).abs().max() > 1e-3 * logits.abs().max()


@pytest.mark.parametrize("hw,out", [((13, 17), (7, 9)), ((13, 17), (29, 31)),
                                    ((9, 11), (9, 40)), ((5, 6), (5, 6))],
                         ids=["down", "up", "mixed", "same"])
def test_interp_matches_jax(hw, out):
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax_ar._interp(jnp.asarray(x), out))
    got = port_ar._interp(_nchw(x), out).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_pyr_up_bicubic_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 7, 9, 5)).astype(np.float32)
    want = np.asarray(jax.jit(jax_ar.pyr_up_bicubic)(jnp.asarray(x)))
    got = port_ar.pyr_up_bicubic(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 14, 18, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_reference_oracle_loads_strictly(tmp_path):
    """The reference-named torch ARnet_seg_mask of
    tests/test_alpha_refine_convert.py, saved as a trainer `.pth`, loads
    into the port strictly (num_batches_tracked ignored) and gives its mask
    logits; a key the port lacks raises."""
    from tests.test_alpha_refine_convert import INPUT_SZ, POOL, _ARnetSegMask
    torch.manual_seed(0)
    oracle = _ARnetSegMask()
    with torch.no_grad():
        for m in oracle.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.6, 1.4)
                m.weight.normal_(1.0, 0.1)
                m.bias.normal_(0, 0.05)
    oracle.eval()
    path = str(tmp_path / "ARcm_seg.pth")
    torch.save({"net": oracle.state_dict()}, path)
    net, _ = port_ar.build_alpha_refine(input_sz=INPUT_SZ, output_sz=INPUT_SZ, device="cpu")
    report = load_variables(path, net, strict=True)
    assert report["missing"] == [] and report["unexpected"] == []
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, INPUT_SZ, INPUT_SZ, 3)).astype(np.float32)
    kernel = rng.standard_normal((1, POOL, POOL, 1024)).astype(np.float32)
    with torch.no_grad():
        want = oracle.forward_test(_nchw(img), _nchw(kernel), (INPUT_SZ, INPUT_SZ))
        got = net(torch.from_numpy(img), torch.from_numpy(kernel))
    _close(got.numpy(), want.permute(0, 2, 3, 1).numpy(), frac=5e-4)
    sd = dict(oracle.state_dict(), **{"refiner.extra.weight": torch.zeros(1)})
    torch.save(sd, path)
    with pytest.raises(ValueError, match="strict"):
        load_variables(path, net, strict=True)


# --------------------------------------------------------------- host side
#: boxes (x, y, w, h) in a 120 x 160 frame: inside, partly outside on each
#: side, reaching the last row and column, large (2x window bigger than the
#: frame), and one whose 2x window is exactly 2 x 64 (cv2's INTER_AREA path)
BOXES = [(50.0, 40.0, 40.0, 30.0), (-12.5, 20.0, 30.0, 25.0), (140.0, 100.0, 30.0, 28.0),
         (60.0, -9.0, 20.0, 40.5), (10.0, 10.0, 150.0, 110.0), (100.3, 70.7, 59.7, 49.3),
         (48.0, 28.0, 64.0, 64.0)]


@pytest.mark.parametrize("pad_mode", ["constant", "replicate"])
@pytest.mark.parametrize("box", BOXES, ids=[f"box{i}" for i in range(len(BOXES))])
def test_se_crops_match_jax(box, pad_mode):
    rng = np.random.default_rng(4)
    frame = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    want, wh, ww = jax_ar.sample_target_se(frame, box, 2.0, S, pad_mode)
    got, gh, gw = port_ar.sample_target_se(frame, box, 2.0, S, pad_mode)
    assert got.dtype == np.uint8 and (gh, gw) == (wh, ww)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_ar.transform_box_to_crop_se(box, gh, gw, S),
                                  jax_ar.transform_box_to_crop_se(box, wh, ww, S))
    # a float64 image (the refine trainer's mask x 255) and map_mask_back
    fl = rng.random((120, 160, 3)) * 255.0
    np.testing.assert_allclose(port_ar.sample_target_se(fl, box, 2.0, S, pad_mode)[0],
                               jax_ar.sample_target_se(fl, box, 2.0, S, pad_mode)[0],
                               rtol=0, atol=1e-5 * 255)
    mask = rng.random((S, S)).astype(np.float32)
    back = port_ar.map_mask_back((120, 160), box, 2.0, mask)
    assert back.shape == (120, 160) and back.dtype == np.float32
    np.testing.assert_allclose(back, jax_ar.map_mask_back((120, 160), box, 2.0, mask),
                               rtol=0, atol=1e-5)


def test_arcmseg_matches_jax(port_net):
    """initialize on frame 0, get_mask on three later frames at the boxes
    of the moving block, against the JAX package's ARcmSeg."""
    frames, boxes = common.frame_sequence(4)
    jw = common.jax_ar_seg()
    pw = port_ar.ARcmSeg(port_net)
    jw.initialize(frames[0], boxes[0])
    pw.initialize(frames[0], boxes[0])
    _close(pw.kernel.numpy(), np.asarray(jw.kernel), what="kernel")
    for k in (1, 2, 3):
        box = [boxes[k][0] + 1.5, boxes[k][1] - 0.5, 25.0, 19.0]
        want = jw.get_mask(frames[k], box)
        got = pw.get_mask(frames[k], box)
        assert got.shape == (120, 160) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
        assert np.mean((got > 0.6) != (want > 0.6)) <= 1e-3
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.max() > 0.0

