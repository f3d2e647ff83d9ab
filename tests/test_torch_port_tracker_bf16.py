"""The port's bf16 serving path (tracking and evaluation) on the CPU against
the JAX package at bf16, the dtype its eval stack defaults to
(eval/evaltracker.py:29-30): the same float32 weights, cast after loading
(`cast_floating`), the same inputs.

bf16 rounds at other points in the two packages, so these are drift
bounds, not equality, and they are the JAX package's own bounds between its
bf16 and f32 paths (tests/test_bf16_eval.py):
  * one forward: `pred_boxes` (cxcywh in [0, 1]) within 5e-2 of JAX bf16 and
    of the port's own f32 forward;
  * a short cached-tracker sequence: mean centre distance to JAX bf16 under
    10 px.
Both sides print their distances beside JAX's bf16-vs-f32 distance on the
same inputs. The largest source of drift: the JAX model attends through
`_attend` on the CPU, which rounds the attention scores to bf16 before the
f32 softmax, where the port's K1-bf16 (like the Pallas kernel) keeps them
f32.

CE at bf16: the ranking scores are bf16 products, so ties are likelier
than at f32, and `jax.lax.top_k` and `torch.topk` order a tie differently.
The seeds here leave no tie at any keep boundary: `_ce_gaps` records the
gap between the last kept and the first dropped score of every CE
selection and the tests require it to be positive.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as
from multi_modal_tracking_tpu.tracking import tracker as jax_tracker
from multi_modal_tracking_tpu.utils.checkpoint import cast_floating as jax_cast_floating

from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.tracking import tracker as port_tracker
from multi_modal_tracking_torch.utils.checkpoint import cast_floating
from multi_modal_tracking_torch.utils.convert import from_jax_variables

from tests.test_torch_port_model import GEOM, _randomise
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

BOX_TOL = 5e-2          # tests/test_bf16_eval.py:49
CENTRE_PX_TOL = 10.0    # tests/test_bf16_eval.py:78
# the geometry of tests/test_bf16_eval.py:24-27 (its head and fusion are the
# spec defaults, CORNER and LNSpecific_2), and the recipe's head and fusion
# at the tiny geometry of tests/test_torch_port_model.py, also with frozen BN
BF16_EVAL = dict(search_size=96, template_size=64, embed_dim=64, depth=2, num_heads=2,
                 head_dim=64, fusion_layers=1, ce_loc=(1,), ce_keep_ratio=(0.7,))
GEOMS = {"bf16_eval": (BF16_EVAL, False), "recipe": (GEOM, True),
         "recipe_frozen_bn": (dict(GEOM, head_freeze_bn=True), True)}


def _to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _twins(geom, seed, randomise):
    """(JAX f32 model, JAX bf16 model, f32 variables as numpy, the JAX
    bf16-cast variables, the port's f32 model, the port's bf16 model)."""
    spec = jax_as.RGBTSpec(drop_path_rate=0.0, **geom)
    m32 = jax_as.MixFormerRGBT(spec=spec, dtype=jnp.float32)
    m16 = jax_as.MixFormerRGBT(spec=spec, dtype=jnp.bfloat16)
    ts, ss = geom["template_size"], geom["search_size"]
    t, s = jnp.zeros((2, ts, ts, 3)), jnp.zeros((2, ss, ss, 3))
    v32 = jax.jit(m32.init)(jax.random.PRNGKey(seed), t, t, s)
    v32 = _randomise(v32, seed) if randomise else _to_numpy(v32)
    # a frozen BN's variance (bn_var) must stay positive; _randomise draws
    # it as it draws the other statistics
    v32["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, x: np.abs(x) + 0.6 if path[-1].key == "bn_var" else x,
        v32.get("batch_stats", {}))
    v16 = jax_cast_floating(jax.tree.map(jnp.asarray, v32), jnp.bfloat16)
    p32 = port_as.MixFormerRGBT(port_as.RGBTSpec(**geom)).eval()
    p32.load_state_dict(from_jax_variables(v32), strict=True)
    p16 = cast_floating(copy.deepcopy(p32), torch.bfloat16)
    return m32, m16, v32, v16, p32, p16


@pytest.fixture(scope="module", params=list(GEOMS))
def twins(request):
    geom, randomise = GEOMS[request.param]
    return request.param, geom, _twins(geom, 0, randomise)


@pytest.fixture
def ce_gaps(monkeypatch):
    gaps = []
    select = port_as._ce_select

    def recorded(attn_m, tokens, gidx, n_mt, lens_keep):
        top = torch.sort(attn_m.float(), dim=1, descending=True).values
        gaps.append(float((top[:, lens_keep - 1] - top[:, lens_keep]).min()))
        return select(attn_m, tokens, gidx, n_mt, lens_keep)
    monkeypatch.setattr(port_as, "_ce_select", recorded)
    return gaps


def _inputs(geom, seed):
    rng = np.random.default_rng(seed)
    ts, ss = geom["template_size"], geom["search_size"]
    return (rng.standard_normal((2, ts, ts, 3)).astype(np.float32),
            rng.standard_normal((2, ts, ts, 3)).astype(np.float32),
            rng.standard_normal((2, ss, ss, 3)).astype(np.float32))


def _jax_boxes(model, variables, t, ot, s):
    fn = jax.jit(lambda v, a, b, c: model.apply(v, a, b, c, None)["pred_boxes"])
    return np.asarray(fn(variables, t, ot, s), np.float32)


def _port_boxes(model, t, ot, s, cached=False):
    t, ot, s = (torch.from_numpy(x) for x in (t, ot, s))
    with torch.no_grad():
        if cached:
            return model.forward_track(model.set_online(t, ot), s)["pred_boxes"].numpy()
        return model(t, ot, s)["pred_boxes"].numpy()


def test_cast_floating_matches_jax():
    """The port's cast_floating against JAX's on the same variables: every
    parameter (the JAX `params` collection) bf16 and equal bit for bit to
    JAX's cast, every buffer (`batch_stats`: BN running statistics)
    still float32 and unchanged."""
    for geom in (GEOM, dict(GEOM, head_freeze_bn=True)):
        _, _, v32, v16, p32, p16 = _twins(geom, 1, True)
        want = from_jax_variables(_to_numpy(v16))
        params = dict(p16.named_parameters())
        assert set(params) == set(from_jax_variables({"params": v32["params"]}))
        for key, got in p16.state_dict().items():
            if key in params:
                assert got.dtype == torch.bfloat16, key
                assert torch.equal(got.float(), want[key]), key
                assert torch.equal(got, p32.state_dict()[key].to(torch.bfloat16)), key
            else:
                assert got.dtype == p32.state_dict()[key].dtype, key
                assert torch.equal(got, p32.state_dict()[key]), key
        assert any(k.endswith("running_var") for k in want)


def test_forward_bf16_near_jax_bf16_and_port_f32(twins, ce_gaps):
    name, geom, (m32, m16, v32, v16, p32, p16) = twins
    t, ot, s = _inputs(geom, 10)
    j32, j16 = _jax_boxes(m32, v32, t, ot, s), _jax_boxes(m16, v16, t, ot, s)
    got, f32 = _port_boxes(p16, t, ot, s), _port_boxes(p32, t, ot, s)
    assert np.isfinite(got).all() and got.shape == j16.shape
    d_jax, d_f32 = float(np.abs(got - j16).max()), float(np.abs(got - f32).max())
    print(f"{name}: port bf16 - JAX bf16 {d_jax:.3g}, port bf16 - port f32 {d_f32:.3g}, "
          f"JAX bf16 - JAX f32 {float(np.abs(j16 - j32).max()):.3g}")
    assert d_jax <= BOX_TOL and d_f32 <= BOX_TOL
    assert ce_gaps and min(ce_gaps) > 0, ce_gaps


def test_cached_path_near_full_forward_bf16(twins, ce_gaps):
    """Inside the port at bf16: set_online + forward_track against the full
    forward. Not bit-equal: K1-bf16 runs other key orders and the GEMMs
    other shapes, and a flipped bf16 rounding propagates. Bound: 5e-2, the
    bf16 bound; at the recipe's tiny geometry on other seeds the JAX model's
    own cached path came up to 2.3e-2 from its full forward at bf16."""
    name, geom, (_, _, _, _, _, p16) = twins
    t, ot, s = _inputs(geom, 11)
    d = float(np.abs(_port_boxes(p16, t, ot, s, cached=True)
                     - _port_boxes(p16, t, ot, s)).max())
    print(f"{name}: port bf16 cached - full {d:.3g}")
    assert d <= BOX_TOL
    assert ce_gaps and min(ce_gaps) > 0, ce_gaps


def _centre_distance(a, b):
    return np.hypot((a[:, 0] + a[:, 2] / 2) - (b[:, 0] + b[:, 2] / 2),
                    (a[:, 1] + a[:, 3] / 2) - (b[:, 1] + b[:, 3] / 2))


TRACK_KW = dict(template_factor=2.0, template_size=64, search_factor=4.5, search_size=96,
                update_interval=3)


@pytest.mark.parametrize("seed", [1, 2])
def test_cached_tracker_bf16_near_jax_bf16(seed, ce_gaps):
    """tests/test_bf16_eval.py's sequence (9 random 120x160 frames, update
    interval 3) at its geometry and init weights: the port's bf16 cached
    tracker against RGBTCachedTrackerJit at bf16, and against the port's f32
    tracker and its own full-forward tracker at bf16."""
    m32, m16, v32, v16, p32, p16 = _twins(BF16_EVAL, 0, False)
    rng = np.random.default_rng(seed)
    fv = rng.integers(0, 255, (9, 120, 160, 3), dtype=np.uint8)
    fi = rng.integers(0, 255, (9, 120, 160), dtype=np.uint8)
    init = {"init_bbox": [70.0, 50.0, 16.0, 14.0]}
    out = {}
    for tag, make in (
            ("jax_f32", lambda: jax_tracker.RGBTCachedTrackerJit(
                model=m32, variables=jax.tree.map(jnp.asarray, v32), scan_chunk=4, **TRACK_KW)),
            ("jax_bf16", lambda: jax_tracker.RGBTCachedTrackerJit(
                model=m16, variables=v16, scan_chunk=4, **TRACK_KW)),
            ("port_f32", lambda: port_tracker.RGBTCachedTracker(p32, device="cpu", **TRACK_KW)),
            ("port_bf16", lambda: port_tracker.RGBTCachedTracker(p16, device="cpu", **TRACK_KW)),
            ("port_bf16_full", lambda: port_tracker.RGBTTracker(p16, device="cpu", **TRACK_KW))):
        tr = make()
        tr.initialize([fv[0], fi[0]], init)
        out[tag] = np.asarray(tr.track_chunk(fv[1:], fi[1:], fetch=True), np.float64)
    got = out["port_bf16"]
    assert np.isfinite(got).all()
    d = {k: float(_centre_distance(got, v).mean()) for k, v in out.items() if k != "port_bf16"}
    print(f"seed {seed}: port bf16 mean centre distance (px) to {d}; JAX bf16 - JAX f32 "
          f"{float(_centre_distance(out['jax_bf16'], out['jax_f32']).mean()):.3g}")
    assert d["jax_bf16"] < CENTRE_PX_TOL
    assert d["port_f32"] < CENTRE_PX_TOL and d["port_bf16_full"] < CENTRE_PX_TOL
    assert ce_gaps and min(ce_gaps) > 0, ce_gaps


# ------------------------------------------------- entry points and guards
TINY = dict(embed_dim=32, depth=2, num_heads=2, head_dim=32, fusion_layers=1, ce_loc=(1,),
            ce_keep_ratio=(0.7,))


@pytest.fixture
def tiny_params(monkeypatch, tmp_path):
    """create_tracker's parameters with the recipe at template 64 / search 96
    and the tiny TINY spec, and a float32 checkpoint of a seed-3 model."""
    from multi_modal_tracking_torch.eval import evaltracker
    from multi_modal_tracking_torch.eval.params import get_parameters
    from multi_modal_tracking_torch.models.build import build_model
    build = evaltracker.build_model
    monkeypatch.setattr(evaltracker, "build_model", lambda *a, **kw: build(
        *a, spec_overrides=TINY, **kw))
    params = get_parameters("asymmetric_shared_ce", "attention_lasher_newfusion_2layer")
    params.cfg.DATA.TEMPLATE.SIZE, params.cfg.DATA.SEARCH.SIZE = 64, 96
    params.template_size, params.search_size = 64, 96
    sd = build_model(params.script, params.cfg, device="cpu", seed=3,
                     spec_overrides=TINY).state_dict()
    params.checkpoint = str(tmp_path / "MixFormerRGBT_ep0001.pth.tar")
    torch.save({"epoch": 1, "net": sd}, params.checkpoint)
    return params, sd


def test_create_tracker_bf16_loads_then_casts(tiny_params, monkeypatch):
    """create_tracker(dtype=bf16) in the JAX package's order: the float32
    model is loaded strictly, then cast; parameters bf16, buffers float32
    and equal to the file's."""
    from multi_modal_tracking_torch.eval import evaltracker
    params, sd = tiny_params
    load = evaltracker.load_variables
    seen = []

    def watched(path, model, strict=True):
        seen.append({p.dtype for p in model.parameters()})
        return load(path, model, strict=strict)
    monkeypatch.setattr(evaltracker, "load_variables", watched)
    tracker = evaltracker.create_tracker(params, device="cpu", dtype=torch.bfloat16)
    assert seen == [{torch.float32}]
    names = dict(tracker.model.named_parameters())
    for key, got in tracker.model.state_dict().items():
        want = sd[key].to(torch.bfloat16) if key in names else sd[key]
        assert got.dtype == want.dtype and torch.equal(got, want), key
    rng = np.random.default_rng(0)
    fv = rng.integers(0, 255, (4, 120, 160, 3), dtype=np.uint8)
    fi = rng.integers(0, 255, (4, 120, 160), dtype=np.uint8)
    tracker.initialize([fv[0], fi[0]], {"init_bbox": [70.0, 50.0, 16.0, 14.0]})
    boxes = tracker.track_chunk(fv[1:], fi[1:])
    assert boxes.dtype == np.float32 and np.isfinite(boxes).all()


def test_eval_cli_and_lockstep_bf16(tiny_params, monkeypatch, tmp_path):
    """`--dtype bfloat16` reaches create_tracker; one stream (run_dataset)
    and lockstep batches of 3 (run_sequences_batched) write float32 text
    result files with finite boxes inside the frame. Lockstep against one
    stream at bf16 is drift, not the f32 0.05 px bound: batch 3 runs other
    GEMM shapes, and a flipped bf16 rounding can move the box; it is printed
    and held to the tracker bound, 10 px mean centre distance."""
    from multi_modal_tracking_torch.eval import datasets, evaltracker, run
    params, _ = tiny_params
    made = []

    def create(p, dataset_name="", device="cuda", dtype=torch.float32):
        made.append(dtype)
        p.template_size, p.search_size = 64, 96
        p.cfg.DATA.TEMPLATE.SIZE, p.cfg.DATA.SEARCH.SIZE = 64, 96
        p.checkpoint = params.checkpoint
        return evaltracker.create_tracker(p, dataset_name, device=device, dtype=dtype)
    monkeypatch.setattr(run, "create_tracker", create)
    monkeypatch.setattr(run, "get_dataset", lambda name: datasets.get_dataset(name, n_frames=6))
    base = ["asymmetric_shared_ce", "attention_lasher_newfusion_2layer", "--device", "cpu",
            "--dtype", "bfloat16", "--chunk", "4", "--dataset_name", "synthetic_rgbt"]
    seq_dir = run.main(base + ["--results_dir", str(tmp_path / "seq")])[0]
    lock_dir = run.main(base + ["--results_dir", str(tmp_path / "lock"),
                                "--batch_sequences", "3"])[0]
    assert made == [torch.bfloat16, torch.bfloat16]
    seqs = datasets.get_dataset("synthetic_rgbt", n_frames=6)
    H, W = seqs[0].frames[0][0].shape[:2]
    dist = []
    for seq in seqs:
        a, b = (np.loadtxt(f"{d}/{seq.name}.txt") for d in (seq_dir, lock_dir))
        for boxes in (a, b):
            assert boxes.shape == (6, 4) and np.isfinite(boxes).all()
            assert (boxes[:, :2] >= 0).all() and (boxes[:, 0] + boxes[:, 2] <= W).all() \
                and (boxes[:, 1] + boxes[:, 3] <= H).all()
        dist.append(float(_centre_distance(a, b).mean()))
    print(f"bf16 lockstep N=3 against one stream, mean centre distance (px): {dist}")
    assert max(dist) < CENTRE_PX_TOL
    with pytest.raises(SystemExit):
        run.main(base[:-4] + ["--dtype", "float16"])


def test_other_dtypes_and_bf16_training_raise(tiny_params, tmp_path):
    """float32 and bfloat16 are the compute dtypes; anything else raises.
    bf16 training keeps float32 parameters: build_model(dtype=bf16) builds
    float32 parameters that compute in bf16, and the train and val steps of
    a model whose parameters were cast to bf16 (for serving) raise.
    TRAIN.AMP is accepted: bf16 is the Trainer's default compute dtype."""
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.models.build import build_model
    from multi_modal_tracking_torch.models.layers import compute_dtype
    from multi_modal_tracking_torch.train.train_step import make_eval_step, make_train_step
    from multi_modal_tracking_torch.utils.device import set_precision
    from tests.test_torch_port_isolation import _train_cfg
    from multi_modal_tracking_torch.train.trainer import Trainer
    params, _ = tiny_params
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(NotImplementedError, match="dtype"):
            set_precision(dtype)
        with pytest.raises(NotImplementedError, match="dtype"):
            create_tracker(params, device="cpu", dtype=dtype)
    model = build_model(params.script, params.cfg, device="cpu", dtype=torch.bfloat16,
                        spec_overrides=TINY)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert compute_dtype(model) == torch.bfloat16
    cast_floating(model, torch.bfloat16)
    for make in (lambda: make_train_step(model, None, device="cpu"),
                 lambda: make_eval_step(model, device="cpu")):
        with pytest.raises(NotImplementedError, match="keeps float32 parameters"):
            make()
    cfg = _train_cfg(small=True)
    cfg.TRAIN.AMP = True
    tr = Trainer("asymmetric_shared_ce", cfg, save_dir=str(tmp_path), device="cpu",
                 spec_overrides=TINY)
    assert compute_dtype(tr.model) == torch.bfloat16
    assert {p.dtype for p in tr.model.parameters()} == {torch.float32}
