"""Shared builders of the Alpha-Refine parity tests
(tests/test_torch_port_{alpha_refine,vot,refine_train}.py): the JAX
AlphaRefineNet at input 64 (masks 64 x 64) with seeded variables, its
ARcmSeg, and the port's net on the same weights.

The JAX variables are not made by `init`: their shapes come from
`jax.eval_shape` of it (a trace, no compile) and every leaf is drawn from
a numpy seed (He-scaled kernels, BatchNorm statistics and affine near the
identity but not at it), so no XLA program is compiled for them. Each
builder runs once per process (functools.lru_cache), so the test files
that run in one process share one JAX ARcmSeg and its compiled programs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from multi_modal_tracking_tpu.models import alpha_refine as jax_ar

from multi_modal_tracking_torch.models import alpha_refine as port_ar
from multi_modal_tracking_torch.utils.convert import from_jax_variables

INPUT_SZ = 64
SPEC = dict(input_sz=INPUT_SZ, output_sz=INPUT_SZ)


def seeded_variables(module, seed, *init_args, method=None):
    """Variables of a flax module with the shapes `init` gives, drawn from
    `seed`: kernels normal with deviation sqrt(1 / fan_in), biases 0.05,
    BN scale in [0.8, 1.2], bias and mean 0.05, var in [0.6, 1.4]."""
    shapes = jax.eval_shape(lambda r: module.init(r, *init_args, method=method),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = np.prod(s.shape[:-1])
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.6, 1.4, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def jax_alpha_refine(output_sz=INPUT_SZ):
    """(JAX AlphaRefineNet at input 64 with masks output_sz^2, its numpy
    variables; the same variables for every output_sz)."""
    net = jax_ar.AlphaRefineNet(spec=jax_ar.RefineSpec(input_sz=INPUT_SZ, output_sz=output_sz))
    p = jnp.zeros((1, INPUT_SZ, INPUT_SZ, 3), jnp.float32)
    b = jnp.asarray([[16.0, 16.0, 32.0, 32.0]])
    if output_sz != INPUT_SZ:
        return net, jax_alpha_refine()[1]
    return net, seeded_variables(net, 0, p, b, p, method=net.forward_train)


@functools.lru_cache(maxsize=None)
def jax_ar_seg():
    """The JAX package's ARcmSeg on those variables (its jitted programs
    compile at their first call)."""
    net, variables = jax_alpha_refine()
    return jax_ar.ARcmSeg(variables, net.spec)


def port_alpha_refine(output_sz=INPUT_SZ):
    """A fresh port AlphaRefineNet on the CPU with the JAX variables loaded
    strictly."""
    net, _ = port_ar.build_alpha_refine(input_sz=INPUT_SZ, output_sz=output_sz, device="cpu")
    net.load_state_dict(from_jax_variables(jax_alpha_refine()[1]), strict=True)
    return net


def frame_sequence(n, h=120, w=160, seed=0):
    """n uint8 RGB frames of textured noise with a bright 24 x 18 block
    moving 3, 2 px a frame, and its boxes (x, y, w, h)."""
    rng = np.random.default_rng(seed)
    frames, boxes = [], []
    for t in range(n):
        f = rng.integers(20, 110, (h, w, 3), dtype=np.uint8)
        x, y = 50 + 3 * t, 40 + 2 * t
        f[y:y + 18, x:x + 24] = (230, 60, 40)
        frames.append(f)
        boxes.append([float(x), float(y), 24.0, 18.0])
    return frames, boxes
