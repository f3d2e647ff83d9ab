"""The whole slice: the port's tracking loops on the CPU against the JAX
package's jitted loops, on the same weights and the same synthetic RGB-T
sequence (the one of tests/test_tracking_loop_parity.py: 240x320 textured
noise with a bright moving square, replicated-gray TIR).

Each frame runs the joint crop, JET, normalisation, the tiny flagship
(CE at blocks 1/3, LNSpecific deformable fusion, CORNER_UP head), the map
back and clip_box(margin=10); the online template / template cache is
rebuilt at frame 3 (update interval 3). atol 0.02 px is the tolerance
tests/test_tracking_loop_parity.py holds the JAX loop to its torch oracle
with.
"""
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.tracking import tracker as jax_tracker

from multi_modal_tracking_torch.tracking import tracker as port_tracker

from tests.test_torch_port_model import GEOM, S_SZ, T_SZ, _pair
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 240, 320
N_FRAMES = 6
TEMPLATE_FACTOR, SEARCH_FACTOR = 2.0, 4.5
UPDATE_INTERVAL = 3


def _frames(seed):
    rng = np.random.default_rng(seed)
    fv = rng.integers(0, 120, (N_FRAMES, H, W, 3), dtype=np.uint8)
    fi = rng.integers(0, 120, (N_FRAMES, H, W, 3), dtype=np.uint8)
    for t in range(N_FRAMES):
        x, y = 80 + 5 * t, 60 + 3 * t
        fv[t, y:y + 48, x:x + 48] = 230
        fi[t, y:y + 48, x:x + 48] = 200
        fi[t] = fi[t][..., :1].repeat(3, axis=-1)
    return fv, fi, np.array([80.0, 60.0, 48.0, 48.0], np.float32)


@pytest.fixture(scope="module")
def pair():
    return _pair(GEOM, 5)


KW = dict(template_factor=TEMPLATE_FACTOR, template_size=T_SZ,
          search_factor=SEARCH_FACTOR, search_size=S_SZ, update_interval=UPDATE_INTERVAL)


@pytest.mark.parametrize("jax_cls,port_cls,seed", [
    (jax_tracker.RGBTCachedTrackerJit, port_tracker.RGBTCachedTracker, 0),
    (jax_tracker.RGBTTrackerJit, port_tracker.RGBTTracker, 1),
], ids=["cached", "full"])
def test_trajectory_matches_jax(pair, jax_cls, port_cls, seed):
    jmodel, variables, pmodel = pair
    fv, fi, init_box = _frames(seed)
    jt = jax_cls(model=jmodel, variables=variables, **KW)
    jt.initialize([fv[0], fi[0]], {"init_bbox": init_box})
    want = np.asarray([jt.track([fv[t], fi[t]])["target_bbox"] for t in range(1, N_FRAMES)])

    pt = port_cls(pmodel, device="cpu", **KW)
    pt.initialize([fv[0], fi[0]], {"init_bbox": [init_box, init_box + 1]})  # RGB row used
    got = np.asarray([pt.track([fv[t], fi[t]])["target_bbox"] for t in range(1, N_FRAMES)])
    np.testing.assert_allclose(got, want, atol=0.02, rtol=0)
    np.testing.assert_array_equal(pt.current_box(), got[-1].astype(np.float32))


def test_track_chunk_equals_track(pair):
    _, _, pmodel = pair
    fv, fi, init_box = _frames(2)
    a = port_tracker.RGBTCachedTracker(pmodel, device="cpu", **KW)
    a.initialize([fv[0], fi[0]], {"init_bbox": init_box})
    want = np.asarray([a.track([fv[t], fi[t]])["target_bbox"] for t in range(1, N_FRAMES)],
                      np.float32)
    b = port_tracker.RGBTCachedTracker(pmodel, device="cpu", **KW)
    b.initialize([fv[0], fi[0]], {"init_bbox": init_box})
    got = b.track_chunk(fv[1:], fi[1:])
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()

