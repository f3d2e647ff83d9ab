"""The trackers' static-buffer step (the step that tracking/graphs.py
captures as a CUDA graph on the card) run eager on the CPU, at the tiny
flagship geometry of tests/test_torch_port_model.py (CE at blocks 1/3,
LNSpecific fusion, CORNER_UP head), update interval 3:

  * its trajectory equals, bit for bit, the step as the port ran it before
    the state moved into static buffers (`_reference_single`,
    `_reference_lockstep` below: the state rebound every frame, the
    lockstep mask made only while a sequence is frozen), over 6 frames
    (template updates at frames 3 and 6), single stream cached and full,
    lockstep (2 sequences) with one frozen from frame 4, f32 and bf16;
  * it is within 0.02 px of the JAX package's jitted RGBTCachedTrackerJit
    (the bound of tests/test_torch_port_tracker.py; the lockstep step is
    held to BatchedRGBTCachedTrackerJit by tests/test_torch_port_batched.py);
  * snapshot / restore around a chunk gives the boxes of never leaving it;
  * a step dispatches no operation that a CUDA graph cannot hold: no
    `aten._local_scalar_dense` (a value read on the host), no `aten.nonzero`
    (an output size from the device), no `aten.lift_fresh` (a tensor made
    from host data, i.e. a copy from the host).
"""
import copy

import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.tracking import tracker as jax_tracker

from multi_modal_tracking_torch.ops.boxes import clip_box
from multi_modal_tracking_torch.tracking import batched as port_batched
from multi_modal_tracking_torch.tracking import tracker as port_tracker
from multi_modal_tracking_torch.tracking.graphs import OpLog
from multi_modal_tracking_torch.utils.checkpoint import cast_floating

from tests.test_torch_port_model import GEOM, S_SZ, T_SZ, _pair
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 96, 128
N_FRAMES = 7                        # frame 0 initialises; updates at 3 and 6
TF, SF, UI = 2.0, 4.5, 3
KW = dict(template_factor=TF, template_size=T_SZ, search_factor=SF, search_size=S_SZ,
          update_interval=UI)
BOXES0 = np.asarray([[40.0, 30, 30, 24], [50.0, 20, 24, 30]], np.float32)
FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh")


@pytest.fixture(scope="module")
def pair():
    return _pair(GEOM, 41)


@pytest.fixture(scope="module")
def models(pair):
    _, _, m32 = pair
    return {"f32": m32, "bf16": cast_floating(copy.deepcopy(m32), torch.bfloat16)}


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (n, H, W, 3), np.uint8),
            rng.integers(0, 255, (n, H, W, 3), np.uint8))


def _crop(fv, fi, box, template):
    factor, size = (TF, T_SZ) if template else (SF, S_SZ)
    if fv.dim() == 4:
        return port_tracker._prep_rgbt_batch(fv, fi, box, factor, size)
    return port_tracker._prep_rgbt(fv, fi, box, factor, size)


def _forward(model, cached, template, online, cache, s_vi):
    if cached:
        return model.forward_track(cache, s_vi, None, use_ce_template_mask=False)
    return model(template, online, s_vi, None, use_ce_template_mask=False)


@torch.no_grad()
def _reference_single(model, cached, fv, fi, box0):
    """The single-stream step as the port ran it before its state moved
    into static buffers: each frame rebinds the box, the online template
    and the template cache."""
    fv, fi = torch.from_numpy(fv), torch.from_numpy(fi)
    state = torch.from_numpy(box0)
    tv, ti, _ = _crop(fv[0], fi[0], state, True)
    template = online = torch.cat([tv, ti])
    cache = model.set_online(template, template) if cached else None
    out = []
    for k in range(1, fv.shape[0]):
        sv, si, rf = _crop(fv[k], fi[k], state, False)
        o = _forward(model, cached, template, online, cache, torch.cat([sv, si]))
        pred = o["pred_boxes"].reshape(-1, 4).mean(dim=0) * (S_SZ / rf)
        state = clip_box(port_tracker._map_box_back(pred, state, S_SZ, rf), H, W, margin=10)
        if k % UI == 0:
            tv, ti, _ = _crop(fv[k], fi[k], state, True)
            online = torch.cat([tv, ti])
            cache = model.set_online(template, online) if cached else None
        out.append(state)
    return torch.stack(out).numpy()


@torch.no_grad()
def _reference_lockstep(model, cached, fv, fi, ok, boxes0):
    """The lockstep step as the port ran it before: the state rebound every
    frame, the mask a tensor only while some sequence is frozen."""
    fv, fi = torch.from_numpy(fv), torch.from_numpy(fi)
    select = port_batched._select
    state = torch.from_numpy(boxes0)
    tv, ti, _ = _crop(fv[0], fi[0], state, True)
    template = online = torch.cat([tv, ti])
    cache = model.set_online(template, template) if cached else None
    ids = np.zeros(len(boxes0), np.int64)
    out = []
    for k in range(1, fv.shape[0]):
        live = None if ok[k].all() else torch.from_numpy(ok[k])
        sv, si, rf = _crop(fv[k], fi[k], state, False)
        o = _forward(model, cached, template, online, cache, torch.cat([sv, si]))
        pred = o["pred_boxes"].reshape(sv.shape[0], -1, 4).mean(dim=1) * (S_SZ / rf)[:, None]
        boxes = clip_box(port_tracker._map_box_back(pred, state, S_SZ, rf), H, W, margin=10)
        state = boxes if live is None else select(live, boxes, state)
        ids += ok[k]
        if ok[k].any() and ids.max() % UI == 0:
            tv, ti, _ = _crop(fv[k], fi[k], state, True)
            new = torch.cat([tv, ti])
            if cached:
                c = model.set_online(template, new)
                cache = c if live is None else select(live, c, cache)
            else:
                online = new if live is None else select(live, new, online)
        out.append(boxes)
    return torch.stack(out).numpy()


def _lockstep_frames(seed):
    """(T, 2, H, W, 3) frames of 2 sequences, the second frozen from frame
    4 (its padded frames repeat frame 3), and the (T, 2) valid mask."""
    seqs = [_frames(N_FRAMES, seed + j) for j in range(2)]
    fv = np.stack([s[0] for s in seqs], axis=1)
    fi = np.stack([s[1] for s in seqs], axis=1)
    ok = np.ones((N_FRAMES, 2), bool)
    ok[4:, 1] = False
    fv[4:, 1], fi[4:, 1] = fv[3, 1], fi[3, 1]
    return fv, fi, ok


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cached", [True, False], ids=["cached", "full"])
def test_single_stream_step_equals_reference(models, cached, dtype):
    model = models[dtype]
    fv, fi = _frames(N_FRAMES, 1 + cached)
    want = _reference_single(model, cached, fv, fi, BOXES0[0])
    cls = port_tracker.RGBTCachedTracker if cached else port_tracker.RGBTTracker
    tr = cls(model, device="cpu", **KW)
    tr.initialize([fv[0], fi[0]], {"init_bbox": BOXES0[0]})
    got = np.asarray([tr.track([fv[k], fi[k]])["target_bbox"] for k in range(1, 4)],
                     np.float32)
    got = np.concatenate([got, tr.track_chunk(fv[4:], fi[4:])])
    assert tr._frame_id == N_FRAMES - 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cached", [True, False], ids=["cached", "full"])
def test_lockstep_step_equals_reference(models, cached, dtype):
    model = models[dtype]
    fv, fi, ok = _lockstep_frames(10 + 3 * cached)
    want = _reference_lockstep(model, cached, fv, fi, ok, BOXES0)
    cls = port_batched.BatchedRGBTCachedTracker if cached else port_batched.BatchedRGBTTracker
    bt = cls(model, device="cpu", scan_chunk=4, **KW)
    bt.initialize(fv[0], fi[0], BOXES0)
    got = bt.track_block(fv[1:], fi[1:], ok[1:])
    assert bt._frame_ids.tolist() == [6, 3]
    np.testing.assert_array_equal(got, want)


def test_step_matches_jax(pair):
    """Single stream across both template updates; the lockstep step with
    a frozen sequence is held to BatchedRGBTCachedTrackerJit by
    tests/test_torch_port_batched.py test_batched_matches_jax_batched (the
    CPU trackers run this step)."""
    jmodel, variables, pmodel = pair
    fv, fi = _frames(N_FRAMES, 40)
    jt = jax_tracker.RGBTCachedTrackerJit(model=jmodel, variables=variables, **KW)
    jt.initialize([fv[0], fi[0]], {"init_bbox": BOXES0[0]})
    want = np.asarray([jt.track([fv[k], fi[k]])["target_bbox"] for k in range(1, N_FRAMES)])
    pt = port_tracker.RGBTCachedTracker(pmodel, device="cpu", **KW)
    pt.initialize([fv[0], fi[0]], {"init_bbox": BOXES0[0]})
    np.testing.assert_allclose(pt.track_chunk(fv[1:], fi[1:]), want, atol=0.02, rtol=0)


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "full"])
def test_snapshot_restore_around_chunk(pair, cached):
    """A chunk that crosses a template update, tracked, undone with
    restore and tracked again, gives the boxes of tracking it once; the
    state buffers stay the same tensors."""
    _, _, model = pair
    fv, fi = _frames(N_FRAMES, 50 + cached)
    cls = port_tracker.RGBTCachedTracker if cached else port_tracker.RGBTTracker
    a = cls(model, device="cpu", **KW)
    a.initialize([fv[0], fi[0]], {"init_bbox": BOXES0[1]})
    a.track_chunk(fv[1:3], fi[1:3])
    want = a.track_chunk(fv[3:], fi[3:])
    b = cls(model, device="cpu", **KW)
    b.initialize([fv[0], fi[0]], {"init_bbox": BOXES0[1]})
    b.track_chunk(fv[1:3], fi[1:3])
    snap = b.snapshot()
    bufs = [getattr(b, k) for k in b._STATE]
    b.track_chunk(fv[3:6], fi[3:6])
    b.restore(snap)
    assert all(getattr(b, k) is t for k, t in zip(b._STATE, bufs))
    assert b._frame_id == 2
    np.testing.assert_array_equal(b.track_chunk(fv[3:], fi[3:]), want)


@pytest.mark.parametrize("update", [False, True], ids=["search", "search_update"])
@pytest.mark.parametrize("lockstep", [False, True], ids=["single", "lockstep"])
def test_step_dispatches_nothing_from_the_host(models, lockstep, update):
    """After a first step (which fills the first-use caches, as the graph
    runner's eager first step of a key does), one step records none of
    FORBIDDEN."""
    model = models["bf16"]
    fv, fi, ok = _lockstep_frames(60)
    if lockstep:
        t = port_batched.BatchedRGBTCachedTracker(model, device="cpu", **KW)
        t.initialize(fv[0], fi[0], BOXES0)
        inputs = port_batched.StaticInputs([fv.shape[1:], fi.shape[1:], (2,)],
                                           [torch.uint8, torch.uint8, torch.bool], t.device)
        inputs.load_host((fv[1], fi[1], ok[4]))
        step = lambda: t._advance(*inputs.tensors, update)   # noqa: E731
    else:
        t = port_tracker.RGBTCachedTracker(model, device="cpu", **KW)
        t.initialize([fv[0, 0], fi[0, 0]], {"init_bbox": BOXES0[0]})
        inputs = t._inputs_for(fv.shape[2:], fi.shape[2:])
        inputs.load_host((fv[1, 0], fi[1, 0]))
        step = lambda: t._advance(*inputs.tensors, update)   # noqa: E731
    step()
    with OpLog() as log:
        step()
    assert len(log.ops) > 100
    bad = sorted({op for op in log.ops if op.startswith(FORBIDDEN)})
    assert not bad, bad
