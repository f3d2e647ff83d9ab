"""The port's lockstep trackers with the sequence batch sharded over devices
(`devices=[...]`, multi_modal_tracking_torch.tracking.batched; the JAX
package's `mesh=` data axis, tests/test_batched_tracking.py:319-349) on the
CPU, at the tiny flagship geometry of tests/test_torch_port_model.py, N = 4
sequences over devices ["cpu", "cpu"], 6 frames across template updates
(interval 3), one torch thread:

  * the plain, cached and online-cached twins give the unsharded tracker's
    boxes bit for bit: each shard runs its sequences' rows of the same
    products. The online twin's scores may differ by an ulp (the score
    branch's products at batch 2 and 4 sum in another order): 1e-6;
  * they are within 0.02 px (the cross-package bound of
    tests/test_torch_port_batched.py) of the JAX lockstep tracker run with
    its sequence batch sharded over a 2-device data mesh, scores within
    1e-4. On these frames the port's unsharded tracker is 2.98e-3 px from
    JAX's unsharded one by frame 5 (random weights amplify the f32
    differences), so JAX's own 1e-3 px bound between its sharded and
    unsharded runs cannot hold across packages; the sharding adds nothing
    on the port's side and 7.6e-6 px on JAX's;
  * `run_sequences_batched` takes a sharded tracker unchanged;
  * an N the device count does not divide raises.
"""
import numpy as np
import pytest
import jax
from jax.sharding import Mesh

from multi_modal_tracking_tpu.tracking import batched as jax_batched

from multi_modal_tracking_torch.tracking import batched as port_batched

from tests.test_torch_port_model import GEOM, S_SZ, T_SZ, _pair
from tests.test_torch_port_spm import score_pair
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 96, 128
N, T = 4, 6
KW = dict(template_factor=2.0, template_size=T_SZ, search_factor=4.5, search_size=S_SZ,
          update_interval=3)
BOXES0 = np.asarray([[40.0, 30, 30, 24], [50.0, 20, 24, 30], [30.0, 40, 20, 20],
                     [44.0, 36, 26, 22]], np.float32)
DEVICES = ["cpu", "cpu"]
TWINS = {
    "plain": (port_batched.BatchedRGBTTracker, jax_batched.BatchedRGBTTrackerJit, False),
    "cached": (port_batched.BatchedRGBTCachedTracker, jax_batched.BatchedRGBTCachedTrackerJit,
               False),
    "online_cached": (port_batched.BatchedRGBTOnlineCachedTracker,
                      jax_batched.BatchedRGBTOnlineCachedTrackerJit, True),
}


@pytest.fixture(scope="module")
def pairs():
    return {False: _pair(GEOM, 31), True: score_pair(3, bias=0.45)}


def _frames(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (T, N, H, W, 3), np.uint8),
            rng.integers(0, 255, (T, N, H, W, 3), np.uint8))


def _run(tr, fv, fi):
    tr.initialize(fv[0], fi[0], BOXES0)
    out = tr.track_block(fv[1:], fi[1:])
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("twin", list(TWINS))
def test_devices_equal_unsharded_and_jax_mesh(pairs, twin):
    port_cls, jax_cls, scored = TWINS[twin]
    jmodel, variables, pmodel = pairs[scored]
    fv, fi = _frames(5)
    want = _run(port_cls(pmodel, device="cpu", scan_chunk=4, **KW), fv, fi)
    sharded = port_cls(pmodel, device="cpu", scan_chunk=4, devices=DEVICES, **KW)
    got = _run(sharded, fv, fi)
    assert len(sharded._shards) == 2 and all(s.model is pmodel for s in sharded._shards)
    assert got[0].shape == (T - 1, N, 4)
    np.testing.assert_array_equal(got[0], want[0])
    if scored:
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    jt = jax_cls(model=jmodel, variables=variables, scan_chunk=4, mesh=mesh, **KW)
    jax_out = _run(jt, fv, fi)
    np.testing.assert_allclose(got[0], jax_out[0], rtol=0, atol=0.02)
    if scored:
        np.testing.assert_allclose(got[1], jax_out[1], rtol=0, atol=1e-4)
        assert (got[1] > 0.5).any() and (got[1] < 0.5).any()


def test_run_sequences_batched_takes_a_sharded_tracker(pairs, tmp_path):
    from multi_modal_tracking_torch.eval.data import RGBTSequence
    _, _, pmodel = pairs[False]
    fv, fi = _frames(9)
    seqs = [RGBTSequence(f"s{j}", list(zip(fv[:, j], fi[:, j])), "LasHeR",
                         np.tile(BOXES0[j].astype(np.float64), (T, 2, 1))) for j in range(N)]
    cls = port_batched.BatchedRGBTCachedTracker
    one = port_batched.run_sequences_batched(seqs, cls(pmodel, device="cpu", **KW),
                                             str(tmp_path / "one"))
    two = port_batched.run_sequences_batched(seqs, cls(pmodel, device="cpu", devices=DEVICES,
                                                       **KW), str(tmp_path / "two"))
    for a, b in zip(one, two):
        assert a["seq"] == b["seq"]
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        assert open(tmp_path / "one" / f"{a['seq']}.txt").read() == \
            open(tmp_path / "two" / f"{a['seq']}.txt").read()


def test_uneven_shards_raise(pairs):
    _, _, pmodel = pairs[False]
    fv, fi = _frames(1)
    tr = port_batched.BatchedRGBTCachedTracker(pmodel, device="cpu", devices=DEVICES, **KW)
    with pytest.raises(ValueError, match="3 sequences do not split over 2 devices"):
        tr.initialize(fv[0, :3], fi[0, :3], BOXES0[:3])
    with pytest.raises(ValueError, match="empty"):
        port_batched.BatchedRGBTTracker(pmodel, device="cpu", devices=[], **KW)
