"""The port's flagship model (multi_modal_tracking_torch) against the JAX
model, on the same weights and inputs, at a tiny geometry.

Geometry of tests/test_flagship_convert.py: embed 64, 4 heads (D = 16),
depth 4, CE at blocks 1/3 keeping 0.7, template 112, search 176, head
channel 64, 2 fusion layers; with the shipped recipe's CORNER_UP head and
Attention_Fusion_Bimodal_LNSpecific fusion. The JAX variables are drawn at
random (numpy, seeded), including BN statistics and the MSDA offset /
attention-weight kernels that the reference init zeroes, and go to the
port through `from_jax_variables`.

Tolerance: the outputs are boxes normalised to [0, 1]. Both sides run f32
(JAX at "highest" matmul precision); they sum in different orders through
~20 layers, which moves the boxes by up to 2e-6 here. atol 2e-5 is 10x that and
still far below what any wrong layer, key or CE selection gives (>= 1e-3).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as
from multi_modal_tracking_tpu.utils.torch_convert import convert_state_dict

from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.utils.convert import from_jax_variables
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

T_SZ, S_SZ = 112, 176
ATOL = 2e-5
GEOM = dict(search_size=S_SZ, template_size=T_SZ, embed_dim=64, depth=4, num_heads=4,
            head_type="CORNER_UP", head_dim=64,
            fusion_class="Attention_Fusion_Bimodal_LNSpecific", fusion_layers=2,
            ce_loc=(1, 3), ce_keep_ratio=(0.7, 0.7))
NO_CE = dict(GEOM, ce_loc=None, ce_keep_ratio=None)


def _randomise(variables, seed):
    """Perturb every leaf so no layer is at an identity-like init."""
    rng = np.random.default_rng(seed)
    out = {}
    for coll, tree in variables.items():
        def walk(t, path=()):
            if isinstance(t, dict):
                return {k: walk(v, path + (k,)) for k, v in t.items()}
            a = np.asarray(t, np.float32)
            if coll == "batch_stats" and path[-1] == "var":
                return rng.uniform(0.6, 1.5, a.shape).astype(np.float32)
            if coll == "batch_stats":
                return rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
            scale = 0.05 if a.ndim > 1 else 0.1
            return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)
        out[coll] = walk(tree)
    return out


def _inputs(seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((2, T_SZ, T_SZ, 3)).astype(np.float32)
    ot = rng.standard_normal((2, T_SZ, T_SZ, 3)).astype(np.float32)
    s = rng.standard_normal((2, S_SZ, S_SZ, 3)).astype(np.float32)
    return t, ot, s


def _pair(geom, seed):
    jmodel = jax_as.MixFormerRGBT(spec=jax_as.RGBTSpec(drop_path_rate=0.0, **geom))
    tz = jnp.zeros((2, T_SZ, T_SZ, 3), jnp.float32)
    sz = jnp.zeros((2, S_SZ, S_SZ, 3), jnp.float32)
    variables = _randomise(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), tz, tz, sz), seed)
    pmodel = port_as.MixFormerRGBT(port_as.RGBTSpec(**geom)).eval()
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, variables, pmodel


@pytest.fixture(scope="module")
def ce_pair():
    return _pair(GEOM, 0)


@pytest.fixture(scope="module")
def no_ce_pair():
    return _pair(NO_CE, 1)


def _jax_full(jmodel, variables, t, ot, s, mask):
    fn = jax.jit(lambda v, a, b, c: jmodel.apply(v, a, b, c, None,
                                                 use_ce_template_mask=mask)["pred_boxes"])
    return np.asarray(fn(variables, t, ot, s))


def _jax_cached(jmodel, variables, t, ot, s, mask):
    def run(v, a, b, c):
        cache = jmodel.apply(v, a, b, method=type(jmodel).set_online)
        return jmodel.apply(v, cache, c, method=type(jmodel).forward_track,
                            use_ce_template_mask=mask)["pred_boxes"]
    return np.asarray(jax.jit(run)(variables, t, ot, s))


def _port_full(pmodel, t, ot, s, mask):
    with torch.no_grad():
        return pmodel(*(torch.from_numpy(x) for x in (t, ot, s)),
                      use_ce_template_mask=mask)["pred_boxes"].numpy()


def _port_cached(pmodel, t, ot, s, mask):
    with torch.no_grad():
        cache = pmodel.set_online(torch.from_numpy(t), torch.from_numpy(ot))
        return pmodel.forward_track(cache, torch.from_numpy(s),
                                    use_ce_template_mask=mask)["pred_boxes"].numpy()


@pytest.mark.parametrize("mask", [False, True], ids=["all_rows", "ctr_point"])
def test_forward_matches_jax_ce(ce_pair, mask):
    jmodel, variables, pmodel = ce_pair
    t, ot, s = _inputs(10)
    want = _jax_full(jmodel, variables, t, ot, s, mask)
    got = _port_full(pmodel, t, ot, s, mask)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_forward_track_matches_jax_ce(ce_pair):
    jmodel, variables, pmodel = ce_pair
    t, ot, s = _inputs(11)
    want = _jax_cached(jmodel, variables, t, ot, s, False)
    got = _port_cached(pmodel, t, ot, s, False)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_forward_and_track_match_jax_no_ce(no_ce_pair):
    jmodel, variables, pmodel = no_ce_pair
    t, ot, s = _inputs(12)
    np.testing.assert_allclose(_port_full(pmodel, t, ot, s, True),
                               _jax_full(jmodel, variables, t, ot, s, True),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(_port_cached(pmodel, t, ot, s, True),
                               _jax_cached(jmodel, variables, t, ot, s, True),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("mask", [False, True], ids=["all_rows", "ctr_point"])
def test_cached_equals_full_in_port(ce_pair, mask):
    """The cached path runs K1 with other key orders and GEMM sizes, so it
    is not bit-identical; it agrees to rounding."""
    _, _, pmodel = ce_pair
    t, ot, s = _inputs(13)
    np.testing.assert_allclose(_port_cached(pmodel, t, ot, s, mask),
                               _port_full(pmodel, t, ot, s, mask), atol=1e-5, rtol=0)


def test_cross_modal_attention_matches_jax():
    """AsymCrossModalAttention alone: the full forward (one K1 call over the
    fused key layout), template_step and search_step, with the t->s CE
    attention, against the JAX module's XLA path."""
    dim, heads, B, n_mt, n_s = 32, 2, 2, 8, 12
    rng = np.random.default_rng(3)
    x_v = rng.standard_normal((B, n_mt + n_s, dim)).astype(np.float32)
    x_i = rng.standard_normal((B, n_mt + n_s, dim)).astype(np.float32)
    jattn = jax_as.AsymCrossModalAttention(dim=dim, num_heads=heads)
    variables = _randomise(jattn.init(jax.random.PRNGKey(0), x_v, x_i, n_mt), 3)
    pattn = port_as.AsymCrossModalAttention(dim, heads)
    pattn.load_state_dict(from_jax_variables(variables), strict=True)
    tv, ti = (torch.from_numpy(a) for a in (x_v, x_i))

    want = jattn.apply(variables, x_v, x_i, n_mt, return_attention=True)
    with torch.no_grad():
        got = pattn(tv, ti, n_mt, return_attention=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)

    jt = jattn.apply(variables, x_v[:, :n_mt], x_i[:, :n_mt],
                     method=jax_as.AsymCrossModalAttention.template_step)
    js = jattn.apply(variables, x_v[:, n_mt:], x_i[:, n_mt:], jt[2], True, (0, 3),
                     method=jax_as.AsymCrossModalAttention.search_step)
    with torch.no_grad():
        pt = pattn.template_step(tv[:, :n_mt], ti[:, :n_mt])
        ps = pattn.search_step(tv[:, n_mt:], ti[:, n_mt:], pt[2], True, (0, 3))
    for g, w in zip(pt[:2] + ps, jt[:2] + js):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    for key in ("qV", "kV", "vV", "qI", "kI", "vI"):
        np.testing.assert_allclose(pt[2][key].numpy(), np.asarray(jt[2][key]),
                                   atol=1e-5, rtol=1e-5)


def test_fusion_matches_jax():
    """The recipe's LNSpecific deformable fusion (K3 inside) alone, both
    ported modes."""
    from multi_modal_tracking_tpu.models.fusion import build_fusion as jax_build
    from multi_modal_tracking_torch.models.fusion import build_fusion
    rng = np.random.default_rng(4)
    x_v = rng.standard_normal((1, 6, 6, 64)).astype(np.float32)
    x_i = rng.standard_normal((1, 6, 6, 64)).astype(np.float32)
    for cls in ("Attention_Fusion_Bimodal_LNSpecific", "Attention_Fusion_Bimodal_LNSpecific_2"):
        jf = jax_build(cls, 64, 64, 2)
        variables = _randomise(jf.init(jax.random.PRNGKey(0), x_v, x_i), 4)
        pf = build_fusion(cls, 64, 64, 2).eval()
        sd = {k.split(".", 1)[1]: v for k, v in
              from_jax_variables({"params": {"fusion_vi": variables["params"]}}).items()}
        pf.load_state_dict(sd, strict=True)
        want = np.asarray(jf.apply(variables, x_v, x_i))
        with torch.no_grad():
            got = pf(torch.from_numpy(x_v), torch.from_numpy(x_i)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,feat_sz,stride,in_sz", [
    ("CornerPredictor", 10, 16, 10), ("PyramidCornerPredictor", 24, 4, 6)],
    ids=["CORNER", "CORNER_UP"])
def test_corner_heads_match_jax(name, feat_sz, stride, in_sz):
    """Both corner heads alone (BN in eval mode, soft-argmax decode)."""
    from multi_modal_tracking_tpu.models import heads as jax_heads
    from multi_modal_tracking_torch.models import heads as port_heads
    x = np.random.default_rng(6).standard_normal((2, in_sz, in_sz, 48)).astype(np.float32)
    jh = getattr(jax_heads, name)(channel=64, feat_sz=feat_sz, stride=stride)
    variables = _randomise(jh.init(jax.random.PRNGKey(0), x), 6)
    ph = getattr(port_heads, name)(48, 64, feat_sz, stride).eval()
    ph.load_state_dict(from_jax_variables(variables), strict=True)
    want = np.asarray(jh.apply(variables, x))
    with torch.no_grad():
        got = ph(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_build_fusion_rejects_unported_classes():
    """Every FUSION_CLASS of the JAX table is ported
    (tests/test_torch_port_fusion_zoo.py); a name outside it raises."""
    from multi_modal_tracking_torch.models.fusion import build_fusion
    with pytest.raises(ValueError, match="FUSION_CLASS"):
        build_fusion("RGBT_Fusion_4", 64, 64, 2)


def test_from_jax_variables_round_trips(ce_pair):
    """port state dict -> the JAX package's own converter -> the same flax
    variables, strictly (every key mapped, every leaf present)."""
    _, variables, pmodel = ce_pair
    sd = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    back, report = convert_state_dict(sd, variables, strict=True, verbose=False)
    assert not report["skipped"] and not report["missing"]
    for coll in variables:
        flat_a = dict(_leaves(variables[coll]))
        flat_b = dict(_leaves(back[coll]))
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            np.testing.assert_array_equal(np.asarray(flat_b[k]), np.asarray(flat_a[k]))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_ce_keep_schedule_matches_jax():
    for args in [(324, 12, (3, 6, 9), (0.7, 0.7, 0.7), None),
                 (121, 4, (1, 3), (0.7, 0.7), 0.5), (324, 12, (), (), None)]:
        assert port_as.ce_keep_schedule(*args) == jax_as.ce_keep_schedule(*args)
    assert port_as.ce_keep_schedule(324, 12, (3, 6, 9), (0.7,) * 3, None)[0][3:10:3] \
        == [227, 159, 112]
