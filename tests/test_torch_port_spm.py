"""The port's SPM (score prediction module) against the JAX package's, on
the same weights and inputs: PrRoI pooling (`ops/prroi.py`), the score
decoder (`models/score_decoder.py`), and the scored flagship
(`asymmetric_shared_online`: the tiny geometry of
tests/test_torch_port_model.py without CE, as the online recipe has none,
with the score branch) through its full and its cached forward.

Tolerances: PrRoI's outputs and its gradients with respect to the features
and the box coordinates within 1e-5 (both sides f32, JAX at "highest"
matmul precision; the pooled values are O(1) sums of a few hundred
products); the score logits within 1e-4, the boxes within the 2e-5 of
tests/test_torch_port_model.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as
from multi_modal_tracking_tpu.models.score_decoder import ScoreDecoder as JaxScoreDecoder
from multi_modal_tracking_tpu.ops.prroi import prroi_pool as jax_prroi_pool
from multi_modal_tracking_tpu.train.losses import score_loss as jax_score_loss
from multi_modal_tracking_tpu.utils.torch_convert import convert_state_dict

from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.models.score_decoder import ScoreDecoder
from multi_modal_tracking_torch.ops.prroi import prroi_pool
from multi_modal_tracking_torch.train.losses import score_loss
from multi_modal_tracking_torch.utils.convert import from_jax_variables

from tests.test_torch_port_model import NO_CE, S_SZ, T_SZ, _inputs, _randomise

SCORE_ATOL = 1e-4
BOX_ATOL = 2e-5
#: the flax path of the score head's last bias
SCORE_BIAS = ("score_branch", "score_head", "layers_2", "bias")


def score_pair(seed, bias=None, geom=NO_CE):
    """(JAX model, its randomised variables, the port model) of the scored
    flagship at the tiny geometry; `bias` sets the score head's last bias
    on both sides."""
    jmodel = jax_as.MixFormerRGBT(spec=jax_as.RGBTSpec(drop_path_rate=0.0, **geom),
                                  with_score=True)
    tz = jnp.zeros((2, T_SZ, T_SZ, 3), jnp.float32)
    sz = jnp.zeros((2, S_SZ, S_SZ, 3), jnp.float32)
    init = jax.jit(lambda r, a, b, c: jmodel.init(r, a, b, c, run_score_head=True))
    variables = _randomise(init(jax.random.PRNGKey(seed), tz, tz, sz), seed)
    if bias is not None:
        set_score_bias(variables, bias)
    pmodel = port_as.MixFormerRGBT(port_as.RGBTSpec(**geom), with_score=True).eval()
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, variables, pmodel


def set_score_bias(variables, bias: float) -> None:
    node = variables["params"]
    for k in SCORE_BIAS[:-1]:
        node = node[k]
    node[SCORE_BIAS[-1]] = np.full_like(np.asarray(node[SCORE_BIAS[-1]]), bias)


@pytest.fixture(scope="module")
def pair():
    return score_pair(3)


def _rois():
    """[batch index, x0, y0, x1, y1]: inside, partly outside on every side,
    degenerate (zero width), reversed in x (negative area), a sub-pixel
    box."""
    return np.array([[0, 1.3, 2.2, 7.9, 6.1],
                     [1, -2.5, -1.2, 4.4, 12.7],
                     [0, 6.0, 3.0, 13.5, 9.5],
                     [1, 3.0, 2.0, 3.0, 8.0],
                     [0, 5.0, 4.0, 2.0, 6.0],
                     [1, 4.2, 4.3, 4.6, 4.5]], np.float32)


@pytest.mark.parametrize("pooled,scale", [((4, 4), 1.0), ((3, 2), 0.5)], ids=["4x4", "3x2_half"])
def test_prroi_pool_matches_jax(pooled, scale):
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    rois = _rois() / np.array([1, scale, scale, scale, scale], np.float32)
    w = rng.standard_normal((len(rois),) + pooled + (5,)).astype(np.float32)

    def jloss(f, r):
        return jnp.sum(jax_prroi_pool(f, r, *pooled, scale) * w)

    want = np.asarray(jax_prroi_pool(jnp.asarray(feat), jnp.asarray(rois), *pooled, scale))
    gf_want, gr_want = (np.asarray(g) for g in jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(feat), jnp.asarray(rois)))

    f_t = torch.from_numpy(feat).requires_grad_()
    r_t = torch.from_numpy(rois).requires_grad_()
    got = prroi_pool(f_t, r_t, *pooled, scale)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(f_t.grad.numpy(), gf_want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(r_t.grad.numpy()[:, 1:], gr_want[:, 1:], atol=1e-5, rtol=0)
    assert np.abs(want[3:5]).max() == 0.0 and np.abs(got.detach().numpy()[3:5]).max() == 0.0
    assert np.abs(gr_want[[0, 1, 2, 5], 1:]).min() > 0.0        # a real coordinate gradient


def test_score_decoder_matches_jax():
    rng = np.random.default_rng(1)
    B, C, nh = 3, 48, 4
    search = rng.standard_normal((B, 6, 6, C)).astype(np.float32)
    tmpl = rng.standard_normal((B, 8, 4, C)).astype(np.float32)
    box = np.array([[0.1, 0.2, 0.6, 0.7], [0.3, 0.1, 0.5, 0.4], [-0.1, 0.5, 0.9, 1.2]],
                   np.float32)
    jd = JaxScoreDecoder(num_heads=nh, hidden_dim=C, nlayer_head=3)
    variables = _randomise(jd.init(jax.random.PRNGKey(0), search, tmpl, box), 1)
    want = np.asarray(jax.jit(jd.apply)(variables, search, tmpl, box))
    pd = ScoreDecoder(nh, C, 3)
    sd = from_jax_variables({"params": {"score_branch": variables["params"]}})
    pd.load_state_dict({k[len("score_branch."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = pd(*(torch.from_numpy(x) for x in (search, tmpl, box))).numpy()
    assert got.shape == want.shape == (B, 1, 1)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)


def _jax_scored(jmodel, variables, t, ot, s, gt):
    """The full forward on the predicted and on the given box, and
    forward_track, in one program (XLA shares the backbone)."""
    def run(v, a, b, c, g):
        kw = dict(use_ce_template_mask=False, run_score_head=True)
        cache = jmodel.apply(v, a, b, method=type(jmodel).set_online)
        return (jmodel.apply(v, a, b, c, None, **kw),
                jmodel.apply(v, a, b, c, None, gt_bboxes=g, **kw),
                jmodel.apply(v, cache, c, method=type(jmodel).forward_track, **kw))
    return jax.jit(run)(variables, t, ot, s, gt)


def test_scored_model_matches_jax(pair):
    """Boxes and score logits of the full forward (predicted box, and the
    ground-truth box of training) and of forward_track."""
    jmodel, variables, pmodel = pair
    t, ot, s = _inputs(20)
    gt = np.array([[0.3, 0.35, 0.62, 0.7]], np.float32)
    jf, jg, jc = _jax_scored(jmodel, variables, t, ot, s, gt)
    tt, ott, st = (torch.from_numpy(x) for x in (t, ot, s))
    with torch.no_grad():
        pf = pmodel(tt, ott, st, use_ce_template_mask=False, run_score_head=True)
        pg = pmodel(tt, ott, st, use_ce_template_mask=False, run_score_head=True,
                    gt_bboxes=torch.from_numpy(gt))
        pc = pmodel.forward_track(pmodel.set_online(tt, ott), st, use_ce_template_mask=False,
                                  run_score_head=True)
        plain = pmodel(tt, ott, st, use_ce_template_mask=False)
    assert "pred_scores" not in plain
    for got, want in ((pf, jf), (pg, jg), (pc, jc)):
        assert got["pred_scores"].shape == (1, 1, 1)
        np.testing.assert_allclose(got["pred_scores"].numpy(), np.asarray(want["pred_scores"]),
                                   atol=SCORE_ATOL, rtol=0)
        np.testing.assert_allclose(got["pred_boxes"].numpy(), np.asarray(want["pred_boxes"]),
                                   atol=BOX_ATOL, rtol=0)
    assert abs(float(pg["pred_scores"]) - float(pf["pred_scores"])) > 1e-3   # the box matters


def test_score_branch_state_dict_round_trip(pair):
    """The port's reference-named state dict -> the JAX package's converter
    (strict: every key mapped, every leaf present) -> the same variables;
    from_jax_variables names every score leaf as the port's modules do."""
    _, variables, pmodel = pair
    sd = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    assert {"score_branch.score_token", "score_branch.proj_q.1.weight",
            "score_branch.norm2.0.bias", "score_branch.score_head.layers.2.weight"} <= set(sd)
    back, report = convert_state_dict(sd, variables, strict=True, verbose=False)
    assert not report["skipped"] and not report["missing"]
    want = jax.tree_util.tree_leaves_with_path(variables["params"]["score_branch"])
    got = dict(jax.tree_util.tree_leaves_with_path(back["params"]["score_branch"]))
    assert len(want) == len(got) == 29
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))
    assert set(from_jax_variables(variables)) == set(pmodel.state_dict())


def test_score_loss_matches_optax():
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((8, 1, 1))).astype(np.float32)
    labels = (rng.random(8) < 0.5).astype(np.float32)
    want, wm = jax_score_loss(jnp.asarray(logits), jnp.asarray(labels), 1.5)
    got, gm = score_loss(torch.from_numpy(logits), torch.from_numpy(labels), 1.5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(gm["Loss/scores"]), float(wm["Loss/scores"]), rtol=1e-6)
    bce = optax.sigmoid_binary_cross_entropy(logits.reshape(-1), labels).mean()
    np.testing.assert_allclose(float(gm["Loss/scores"]), float(bce), rtol=1e-6)
