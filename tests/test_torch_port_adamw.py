"""The fused AdamW update (ops/adamw.py, kernel csrc/adamw.cu) on the CPU:

  * its plain version, `adamw_fused` on CPU tensors, equals bit for bit a
    numpy model of the kernel's per-element formula (each operation rounded
    once in f32, in the kernel's order), over three updates of two groups
    with their own -lr and with and without weight decay;
  * the kernel's tables (`AdamWTable`) cut every tensor into chunks that
    cover each element exactly once, and stop matching when a tensor of the
    groups is replaced.

The optimizer against optax (1e-6) is tests/test_torch_port_train_step.py.
"""
import numpy as np
import pytest
import torch

from multi_modal_tracking_torch.ops import adamw as port_adamw
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SHAPES = ((3, 5), (70_001,), (1,), (64, 4))


def _state(rng, shapes):
    f32 = lambda a: a.astype(np.float32)          # noqa: E731
    return [[f32(rng.standard_normal(s)) for s in shapes],
            [f32(1e-2 * rng.standard_normal(s)) for s in shapes],
            [f32(1e-3 * rng.standard_normal(s)) for s in shapes],
            [f32(1e-5 * np.abs(rng.standard_normal(s))) for s in shapes]]


def _kernel_model(p, g, m, v, neg_lr, bc1, bc2, wd):
    """csrc/adamw.cu adamw_element on float32 numpy arrays."""
    f = np.float32
    m = m * f(port_adamw.B1) + g * f(1.0 - port_adamw.B1)
    v = v * f(port_adamw.B2) + (g * g) * f(1.0 - port_adamw.B2)
    den = np.sqrt(v / bc2) + f(port_adamw.EPS)
    u = (m / bc1) / den
    if wd:
        u = u + p * f(wd)
    return p + u * neg_lr, m, v


@pytest.mark.parametrize("wd", [0.0, 1e-4], ids=["no_decay", "decay"])
def test_plain_version_is_the_kernel_formula(wd):
    rng = np.random.default_rng(0)
    groups_np = [_state(rng, SHAPES[:2]), _state(rng, SHAPES[2:])]
    groups = [tuple([torch.from_numpy(a.copy()) for a in lst] for lst in g) for g in groups_np]
    lrs = np.float32([-3e-4, -1e-5])
    for count in (1, 2, 3):
        bc = np.float32([1.0 - port_adamw.B1 ** count, 1.0 - port_adamw.B2 ** count])
        assert port_adamw.adamw_fused(groups, torch.from_numpy(lrs), torch.from_numpy(bc),
                                      wd) is None
        for gi, g in enumerate(groups_np):
            for i in range(len(g[0])):
                g[0][i], g[2][i], g[3][i] = _kernel_model(g[0][i], g[1][i], g[2][i], g[3][i],
                                                          lrs[gi], bc[0], bc[1], wd)
    for g_np, g in zip(groups_np, groups):
        for want, got in zip(g_np, g):
            for a, b in zip(want, got):
                assert np.array_equal(a.view(np.int32), b.numpy().view(np.int32))


def test_table_chunks_cover_every_element_once():
    rng = np.random.default_rng(1)
    groups = [tuple([torch.from_numpy(a) for a in lst] for lst in _state(rng, SHAPES))]
    table = port_adamw.AdamWTable(groups)
    numel = [int(np.prod(s)) for s in SHAPES]
    assert table.n_tensors == len(SHAPES) and table.n_elements == sum(numel)
    assert table.numel.tolist() == numel and table.group.tolist() == [0] * len(SHAPES)
    assert table.ptrs.tolist() == [t.data_ptr() for lst in groups[0] for t in lst]
    covered = [np.zeros(n, np.int32) for n in numel]
    for t, s in zip(table.chunk_tensor.tolist(), table.chunk_start.tolist()):
        covered[t][s:s + port_adamw.CHUNK] += 1
    assert all((c == 1).all() for c in covered)
    assert table.n_chunks == sum(-(-n // port_adamw.CHUNK) for n in numel) == 5
    assert table.matches(groups)
    groups[0][1][2] = groups[0][1][2].clone()
    assert not table.matches(groups)
