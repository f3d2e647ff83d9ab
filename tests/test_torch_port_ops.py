"""The port's host-side ops, config and parameters (multi_modal_tracking_torch)
against the JAX package's, on the same numpy inputs."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_modal_tracking_tpu.ops import boxes as jax_boxes
from multi_modal_tracking_tpu.ops import crop as jax_crop
from multi_modal_tracking_tpu.ops import pos_embed as jax_pos
from multi_modal_tracking_tpu.ops.colormap import apply_jet as jax_apply_jet, apply_jet_np
from multi_modal_tracking_tpu.eval import params as jax_params
from multi_modal_tracking_tpu.tracking import tracker as jax_tracker

from multi_modal_tracking_torch.eval import params as port_params
from multi_modal_tracking_torch.ops import boxes, crop, pos_embed
from multi_modal_tracking_torch.ops.colormap import apply_jet
from multi_modal_tracking_torch.tracking import tracker as port_tracker
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def test_apply_jet_bit_exact_all_256_values():
    gray = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(apply_jet(torch.from_numpy(gray)).numpy(),
                                  apply_jet_np(gray).astype(np.float32))
    # replicated-gray 3-channel input goes through the BGR2GRAY fixed point
    rgb = np.repeat(gray[..., None], 3, axis=-1)
    np.testing.assert_array_equal(apply_jet(torch.from_numpy(rgb)).numpy(),
                                  apply_jet_np(rgb).astype(np.float32))


def test_apply_jet_matches_jax_on_colour_and_float_input():
    rng = np.random.default_rng(0)
    colour = rng.integers(0, 256, (20, 24, 3)).astype(np.uint8)
    np.testing.assert_array_equal(apply_jet(torch.from_numpy(colour)).numpy(),
                                  apply_jet_np(colour).astype(np.float32))
    # interpolated crops are float: rounding (half to even) happens inside
    fl = (rng.uniform(0, 255, (30, 30)) // 0.5 * 0.5).astype(np.float32)
    np.testing.assert_array_equal(apply_jet(torch.from_numpy(fl)).numpy(),
                                  np.asarray(jax_apply_jet(jnp.asarray(fl))))


@pytest.mark.parametrize("box", [
    [100.0, 80.0, 48.0, 40.0],        # inside
    [-20.0, -10.0, 60.0, 50.0],       # crosses the top-left border
    [280.0, 200.0, 50.0, 45.5],       # crosses the bottom-right border
    [150.3, 111.7, 7.2, 9.9],         # small, fractional
], ids=["inside", "top_left", "bottom_right", "small"])
@pytest.mark.parametrize("factor,out_sz", [(4.5, 288), (2.0, 128)])
def test_crop_resize_matches_jax(box, factor, out_sz):
    """Crop (uint8 and 2-D inputs) within 1e-4 of the JAX matmul resampler:
    both are two f32 products per pixel with at most 2 nonzero taps, summed
    in different orders."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (240, 320, 3)).astype(np.uint8)
    b = np.asarray(box, np.float32)
    want, want_rf = jax_crop.crop_resize(jnp.asarray(img), jnp.asarray(b), factor, out_sz)
    got, got_rf = crop.crop_resize(torch.from_numpy(img), torch.from_numpy(b), factor, out_sz)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert float(got_rf) == float(want_rf)
    want2, _ = jax_crop.crop_resize(jnp.asarray(img[..., 0]), jnp.asarray(b), factor, out_sz)
    got2, _ = crop.crop_resize(torch.from_numpy(img[..., 0]), torch.from_numpy(b), factor,
                               out_sz)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=1e-4, rtol=0)


def test_normalize_imagenet_matches_jax():
    x = np.random.default_rng(2).uniform(0, 255, (8, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(crop.normalize_imagenet(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_crop.normalize_imagenet(jnp.asarray(x))),
                               atol=1e-6, rtol=0)


def test_prep_rgbt_matches_jax():
    """The tracker's joint bimodal crop + JET + normalisation."""
    rng = np.random.default_rng(3)
    fv = rng.integers(0, 256, (240, 320, 3)).astype(np.uint8)
    fi = np.repeat(rng.integers(0, 256, (240, 320, 1)), 3, axis=-1).astype(np.uint8)
    box = np.asarray([60.0, 40.0, 50.0, 44.0], np.float32)
    jv, ji, jrf, _ = jax_tracker._prep_rgbt(jnp.asarray(fv), jnp.asarray(fi),
                                            jnp.asarray(box), 4.5, 288)
    pv, pi, prf = port_tracker._prep_rgbt(torch.from_numpy(fv), torch.from_numpy(fi),
                                          torch.from_numpy(box), 4.5, 288)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), atol=1e-5, rtol=0)
    assert float(prf) == float(jrf)


@pytest.mark.parametrize("margin", [0, 10])
def test_clip_box_matches_jax(margin):
    rng = np.random.default_rng(4)
    for _ in range(20):
        b = rng.uniform(-60, 380, 4).astype(np.float32)
        b[2:] = np.abs(b[2:]) - 20
        want = np.asarray(jax_boxes.clip_box(jnp.asarray(b), 240, 320, margin=margin))
        got = boxes.clip_box(torch.from_numpy(b), 240, 320, margin=margin).numpy()
        np.testing.assert_array_equal(got, want)


def test_box_conversions_match_jax():
    b = np.random.default_rng(5).uniform(0, 1, (7, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        boxes.box_xyxy_to_cxcywh(torch.from_numpy(b)).numpy(),
        np.asarray(jax_boxes.box_xyxy_to_cxcywh(jnp.asarray(b))))


def test_map_box_back_matches_jax():
    pred = np.asarray([140.0, 150.5, 30.0, 41.0], np.float32)
    prev = np.asarray([90.0, 70.0, 48.0, 48.0], np.float32)
    rf = np.float32(288.0 / 216.0)
    want = jax_tracker._map_box_back(jnp.asarray(pred), jnp.asarray(prev), 288, jnp.asarray(rf))
    got = port_tracker._map_box_back(torch.from_numpy(pred), torch.from_numpy(prev), 288,
                                     torch.tensor(rf))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pos_embeds_equal_jax():
    np.testing.assert_array_equal(pos_embed.get_2d_sincos_pos_embed(64, 7),
                                  jax_pos.get_2d_sincos_pos_embed(64, 7))
    np.testing.assert_array_equal(pos_embed.sine_position_encoding(18, 18, 256),
                                  jax_pos.sine_position_encoding(18, 18, 256))


@pytest.mark.parametrize("script,yaml", [
    ("asymmetric_shared_ce", "attention_lasher_newfusion_2layer"),
    ("asymmetric_shared", "attention_lasher_newfusion_2layer"),
    ("asymmetric_shared_online", "attention_lasher_newfusion_2layer"),
    ("mixformer_vit_rgbt", "attention_lasher_newfusion_2layer"),
    ("mixformer_vit_rgbt_shared", "baseline"),
    ("mixformer_vit_rgbt_unibackbone", "baseline"),
])
def test_parameters_match_jax(script, yaml):
    want = jax_params.get_parameters(script, yaml)
    got = port_params.get_parameters(script, yaml)
    assert got.cfg.to_dict() == want.cfg.to_dict()
    for name in ("template_factor", "template_size", "search_factor", "search_size"):
        assert got.get(name) == want.get(name)
    for ds in ("", "LasHeR", "trackingnet", "VOT20"):
        assert port_params.update_interval_for(got.cfg, ds) == \
            jax_params.update_interval_for(want.cfg, ds)
    assert port_params.update_interval_for(got.cfg, "LasHeR") == 2**31 - 1


def test_strict_overlay_and_unported_script_raise():
    cfg = port_params.get_parameters("asymmetric_shared_ce").cfg
    with pytest.raises(ValueError, match="not exist"):
        cfg.merge_strict({"MODEL": {"BOGUS": 1}})
    # every script of the repo is ported; a name the registry lacks raises
    assert port_params.get_parameters("mixformer_cvt").search_size == 320
    with pytest.raises(KeyError, match="unknown script"):
        port_params.get_parameters("mixformer_cvt_x")
