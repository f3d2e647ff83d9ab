"""The port's classic trackers (multi_modal_tracking_torch/classic:
eco.py, atom.py, dimp.py and the run command) on the CPU against the JAX
package's classic/:

  * short trajectories of ECO (handcrafted, and conv1+layer3; a fixed
    projection with the flat window), ATOM (with and without IoU
    refinement), DiMP-18 and DiMP-50 at small crops, the JAX weights crossed over
    (`from_jax_variables`) and the JAX package's random draws injected
    through the draw hook (dropout masks, IoU proposal jitter): boxes,
    scores and flags frame by frame, ECO's init state;
  * `python -m multi_modal_tracking_torch.classic.run` on synthetic_rgb
    against run_dataset, and its refusals.

The modules and checkpoints are held in
tests/test_torch_port_classic_nets.py, the DCF helpers and solvers in
tests/test_torch_port_classic_ops.py.

Torch runs f32 on one intra-op thread (tests/torch_port_threads.py), JAX at
"highest" matmul precision (tests/conftest.py). Tolerances:
  * trajectories: BOX_PX (1e-2) image pixels on every box coordinate,
    flags equal, scores 1e-3 of their magnitude. Both sides sum the same
    terms in other orders through a ResNet, FFTs and 20 to 100 solver
    iterations. ATOM: ATOM_PX (0.1) and ATOM_SCORE (2e-2): its classifier's
    normal equations are ill-conditioned enough that the JAX package's own
    f32 solve moves with the order of its sums
    (tests/test_torch_port_classic_ops.py::test_atom_filter_solve_sensitivity);
  * DiMP-50's init filter: DIMP50_F64 (3e-4) of its largest entry, port
    against JAX and each against the same SD-GN steps in f64 (the JAX
    package's own f32 filter lies 1.4e-4 from the f64 one, the port's
    3.3e-5);
  * ECO's projection P only up to column signs (eigh's sign is arbitrary;
    the objective does not see it; 1e-3 of its largest entry), the init
    filters' responses to the init samples 1e-3 of their largest magnitude.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.classic.atom import ATOMTracker as JATOM
from multi_modal_tracking_tpu.classic.common import combine_nets
from multi_modal_tracking_tpu.classic.dimp import DiMPTracker as JDiMP
from multi_modal_tracking_tpu.classic.eco import ECOTracker as JECO

from multi_modal_tracking_torch.classic import build_classic_tracker
from multi_modal_tracking_torch.utils.convert import from_jax_variables
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

BOX_PX = 1e-2
ATOM_PX = 0.1
ATOM_SCORE = 2e-2
DIMP50_F64 = 3e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want, rel=1e-4):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=rel * max(np.abs(want).max(), 1e-12))


def _frame(cx, cy, size=32, H=160, W=200, seed=0):
    """tests/test_classic_atom.py's textured frame with a two-colour target."""
    rng = np.random.default_rng(seed)
    img = rng.integers(30, 60, (H, W, 3), np.uint8)
    x0, y0 = int(cx - size // 2), int(cy - size // 2)
    img[y0:y0 + size, x0:x0 + size] = [230, 60, 30]
    img[y0 + 8:y0 + size - 8, x0 + 8:x0 + size - 8] = [30, 60, 230]
    return img


def _moving(n, dx=4.0, dy=3.0, size=32):
    cx, cy = 70.0, 80.0
    frames = []
    for k in range(n):
        frames.append(_frame(cx + dx * k, cy + dy * k, size=size, seed=k))
    return frames, [cx - size / 2, cy - size / 2, size, size]


def jax_draw(seed, offsets):
    """The JAX package's random bits as the port's draw hook: the dropout
    masks' uniform (bernoulli is uniform < p) and the IoU proposals' jitter
    (the site's key folded with the frame)."""
    def draw(site, shape, frame):
        key = jax.random.PRNGKey(seed + offsets[site])
        if site == "proposals":
            key = jax.random.fold_in(key, jnp.asarray(frame, jnp.int32))
        return _t(jax.random.uniform(key, tuple(shape)))
    return draw


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _load_backbone(bb, jax_vars):
    sd = from_jax_variables(_np_tree(jax_vars))
    bb.load_state_dict({k: v for k, v in sd.items() if not k.startswith(("layer4.", "fc."))},
                       strict=True)


def _trajectory(jt, pt, frames, box, flags=True, after_init=None, box_px=BOX_PX,
                score_rel=1e-3):
    """Both trackers over the frames: per frame boxes, scores, flags."""
    jt.initialize(frames[0], {"init_bbox": box})
    pt.initialize(frames[0], {"init_bbox": box})
    if after_init is not None:
        after_init(jt, pt)
    out = []
    for f in frames[1:]:
        out.append((jt.track(f), pt.track(f)))
    for k, (j, p) in enumerate(out, start=1):
        np.testing.assert_allclose(p["target_bbox"], j["target_bbox"], atol=box_px,
                                   err_msg=f"frame {k}")
        np.testing.assert_allclose(p["pred_score"], j["pred_score"],
                                   atol=score_rel * max(abs(j["pred_score"]), 1e-3),
                                   err_msg=f"frame {k}")
        if flags:
            assert p["flag"] == j["flag"], (k, p, j)
    return out


# ------------------------------------------------------------- trajectories
@pytest.fixture(scope="module")
def eco_frames():
    return _moving(6, 3.0, 2.0, size=28)


def _eco_pair(**kw):
    jt = JECO(**kw)
    pt = build_classic_tracker("eco", device="cpu", draw=jax_draw(0, {"dropout": 2}), **kw)
    if hasattr(jt, "_bb_vars"):
        _load_backbone(pt.backbone, jt._bb_vars)
    return jt, pt


def _eco_init_checks(jt, pt):
    """P up to column signs; each bank's filter response to its init
    samples (invariant under the signs) and its memory weights."""
    for b, (P, jP, f, jf, z, jz) in enumerate(zip(pt._state.proj, jt._state.proj,
                                                  pt._state.filter_f, jt._state.filter_f,
                                                  pt._state.samples_f, jt._state.samples_f)):
        P, jP = _np(P), np.asarray(jP)
        sign = np.sign(np.sum(P * jP, axis=0))
        _rel(P * sign, jP, 1e-3)
        resp = torch.einsum("kphw,phw->khw", z, f)
        jresp = jnp.einsum("kphw,phw->khw", jz, jf)
        _rel(resp, jresp, 1e-3)
        np.testing.assert_allclose(_np(pt._state.weights[b]), np.asarray(jt._state.weights[b]),
                                   rtol=1e-6)


@pytest.mark.parametrize("features", ["handcrafted", "conv1+layer3"])
def test_eco_trajectory(eco_frames, features):
    """ECO with the joint (filter, projection) init, the 3-scale fused score
    and a filter update (update_interval 3) within 6 frames."""
    frames, box = eco_frames
    jt, pt = _eco_pair(crop_size=96, search_factor=4.0, features=features, update_interval=3,
                       num_cg_iter=4, init_gn_iter=4, init_cg_per_gn=5)
    _trajectory(jt, pt, frames, box, flags=False, after_init=_eco_init_checks)
    assert int(pt._state.prev_ind[0]) == int(jt._state.prev_ind[0])


def test_eco_fixed_projection_and_flat_window(eco_frames):
    """update_projection=False (the init CG budget on the PCA projection)
    with the scalar Tikhonov window."""
    frames, box = eco_frames
    jt, pt = _eco_pair(crop_size=96, search_factor=4.0, features="conv1", update_interval=2,
                       update_projection=False, use_reg_window=False, init_gn_iter=3,
                       init_cg_per_gn=5)
    _trajectory(jt, pt, frames[:4], box, flags=False)


@pytest.mark.parametrize("refine", [False, True])
def test_atom_trajectory(refine):
    """ATOM at crop 160 with IoU refinement (2 ascent steps, the JAX
    proposal jitter injected) and without it (a 3-scale pyramid), a filter
    update every 3 frames. One Gauss-Newton pass of 6 CG steps per solve:
    at the default two passes the f32 solve is chaotic in JAX itself
    (test_atom_filter_solve_sensitivity), and trajectories that differ by
    rounding alone part by pixels; with one pass they agree within
    ATOM_PX, the scores within ATOM_SCORE of their magnitude (the update
    solve on the 16-slot memory still moves the filter by up to 1e-2 of
    its size)."""
    frames, box = _moving(6)
    kw = dict(crop_size=160, search_factor=4.0, refine=refine, refine_steps=2, num_gn_iter=1,
              num_cg_iter=6, hard_negative_cg_iter=6, update_interval=3)
    if not refine:
        kw["scale_factors"] = (0.98, 1.0, 1.02)
    jt = JATOM(**kw)
    pt = build_classic_tracker("atom", device="cpu", draw=jax_draw(0, {"dropout": 2,
                                                                       "proposals": 3}), **kw)
    pt.net.load_network(from_jax_variables(_np_tree(combine_nets(
        {"backbone": jt._bb_vars, "bb_regressor": jt._iou_vars}))))
    _trajectory(jt, pt, frames, box, box_px=ATOM_PX, score_rel=ATOM_SCORE)


def test_dimp18_trajectory():
    """DiMP-18 at crop 160 (10x10 features) with IoU refinement, the learned
    init and 3 SD-GN steps, an update every 3 frames."""
    frames, box = _moving(5)
    kw = dict(crop_size=160, search_factor=4.0, refine=True, refine_steps=2, init_opt_iter=3,
              update_opt_iter=2, update_interval=3)
    jt = JDiMP(**kw)
    pt = build_classic_tracker("dimp", device="cpu", draw=jax_draw(0, {"dropout": 3,
                                                                       "proposals": 4}), **kw)
    pt.net.load_network(from_jax_variables(_np_tree(combine_nets(
        {"backbone": jt._bb_vars, "classifier": jt._clf_vars, "bb_regressor": jt._iou_vars}))))
    _trajectory(jt, pt, frames, box)
    np.testing.assert_allclose(_np(pt._state.filt).transpose(1, 2, 0), np.asarray(jt._state.filt),
                               atol=1e-4 * np.abs(np.asarray(jt._state.filt)).max())


def _sdgn_f64(t):
    """The tracker's learned init (initializer + init_opt_iter SD-GN steps)
    rerun in f64 on its own f32 init samples."""
    import copy
    A = t.augmenter.num_samples
    x, b = t._state.samples[:A].double(), t._state.boxes[:A].double()
    w0 = copy.deepcopy(t.classifier.filter_initializer).double()(x, b).double()
    return copy.deepcopy(t.classifier.filter_optimizer).double()(w0, x, b, None, t.init_opt_iter)


def test_dimp50_init_filter_and_trajectory():
    """DiMP-50 (ResNet-50, the 1024-channel layer3) at crop 160 with the
    reference's 10 init SD-GN steps: the port's f32 init filter against the
    JAX package's, and each within DIMP50_F64 of its largest entry from
    the same steps in f64 on the port's init samples; then 3 frames with
    IoU refinement, a periodic update and a hard negative (the
    not-found threshold at 0: random weights score the target near 0.22),
    boxes within BOX_PX, flags equal."""
    frames, box = _moving(4)
    kw = dict(arch="resnet50", crop_size=160, search_factor=4.0, refine=True, refine_steps=2,
              update_opt_iter=2, update_interval=2, target_not_found_threshold=0.0)
    jt = JDiMP(**kw)
    pt = build_classic_tracker("dimp", device="cpu", draw=jax_draw(0, {"dropout": 3,
                                                                       "proposals": 4}), **kw)
    pt.net.load_network(from_jax_variables(_np_tree(combine_nets(
        {"backbone": jt._bb_vars, "classifier": jt._clf_vars, "bb_regressor": jt._iou_vars}))))

    def init_checks(jt, pt):
        filt, jfilt = _np(pt._state.filt), np.asarray(jt._state.filt).transpose(2, 0, 1)
        scale = np.abs(jfilt).max()
        want = _np(_sdgn_f64(pt))
        for got, ref in ((filt, jfilt), (filt, want), (jfilt, want)):
            assert np.abs(got - ref).max() <= DIMP50_F64 * scale

    out = _trajectory(jt, pt, frames, box, after_init=init_checks)
    assert [p["flag"] for _, p in out] == ["normal", "normal", "hard_negative"]


# ---------------------------------------------------------------- the command
def test_run_command_against_run_dataset(tmp_path):
    """`classic.run dimp --dataset_name synthetic_rgb --sequence
    synthetic_00 --device cpu`: the result file equals an in-process
    run_dataset of the same tracker, byte for byte."""
    from multi_modal_tracking_torch.classic import run
    from multi_modal_tracking_torch.eval.datasets import get_dataset
    from multi_modal_tracking_torch.eval.running import run_dataset
    params = dict(crop_size=64, refine=False, init_opt_iter=1, update_interval=5)
    a, b = tmp_path / "cli", tmp_path / "direct"
    stats = run.main(["dimp", "--dataset_name", "synthetic_rgb", "--sequence", "synthetic_00",
                      "--results_dir", str(a), "--device", "cpu",
                      "--params"] + [f"{k}={v}" for k, v in params.items()])
    assert len(stats) == 1
    ds = get_dataset("synthetic_rgb")
    run_dataset(type(ds)([ds["synthetic_00"]]),
                build_classic_tracker("dimp", device="cpu", **params), str(b))
    got = (a / "synthetic_00.txt").read_bytes()
    assert got == (b / "synthetic_00.txt").read_bytes() and len(got.splitlines()) == 40
    # skipped when done, unless --rerun
    assert run.main(["dimp", "--dataset_name", "synthetic_rgb", "--sequence", "synthetic_00",
                     "--results_dir", str(a), "--device", "cpu"]) == []


def test_run_command_refuses_multimodal_and_eco_checkpoints(tmp_path):
    from multi_modal_tracking_torch.classic import run
    with pytest.raises(SystemExit):
        run.main(["atom", "--dataset_name", "synthetic_rgbt", "--device", "cpu",
                  "--results_dir", str(tmp_path)])
    ck = tmp_path / "x.pth"
    torch.save({"net": {}}, ck)
    with pytest.raises(SystemExit):
        run.main(["eco", "--dataset_name", "synthetic_rgb", "--sequence", "synthetic_00",
                  "--checkpoint", str(ck), "--device", "cpu", "--results_dir", str(tmp_path),
                  "--params", "crop_size=64"])
    assert not os.path.exists(tmp_path / "synthetic_00.txt")
