"""Multi-scale deformable attention sampling (MSDeformAttn core): kernels K3
(forward) and K4 (backward) and their plain versions.

Shapes (L levels with static spatial shapes):
  value              : (B, S, M, D)        S = sum_l H_l * W_l
  spatial_shapes     : ((H_0, W_0), ...)
  sampling_locations : (B, Lq, M, L, P, 2) normalised to [0, 1], (x, y)
  attention_weights  : (B, Lq, M, L, P)
  returns            : (B, Lq, M * D)

Per (query, head, level, point) a bilinear sample at pixel coordinate
loc * size - 0.5 with zero padding outside the map — the numerics of
grid_sample(align_corners=False, padding_mode='zeros') — weighted by the
attention weights and summed.

`ms_deform_attn` goes through a `torch.autograd.Function` whenever a
gradient is to be taken: its forward runs the
hand-written CUDA kernel K3 (`csrc/msda.cu`) for CUDA tensors and
`ms_deform_attn_ref` for CPU tensors; its backward runs K4
(`csrc/msda_bwd.cu`) for CUDA tensors and `ms_deform_attn_bwd_ref` for CPU
tensors. Anything else raises. There is no fallback from a kernel to a
plain version. Which of its kernels K3 and K4 launch at a shape is decided
by `msda_plan`, from the shape alone.

bf16 value and attention weights with f32 locations (the JAX package's
dtype) go to K3-bf16 (the bf16 kernels of `csrc/msda.cu`) for CUDA
tensors and `ms_deform_attn_bf16_ref` for CPU tensors; the output is bf16.
Under autograd their backward is K4-bf16 (the bf16 kernels of
`csrc/msda_bwd.cu`) for CUDA tensors and `ms_deform_attn_bwd_bf16_ref` for
CPU tensors, with the gradients in the primal dtypes: dValue and dAttw
bf16, dLoc f32. Both take the Pallas kernel's tap matrix A (`_bf16_tap_rows`)
into the tensor cores where `msda_plan` gives them their tap kernels.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from multi_modal_tracking_torch.ops import _build


def _corners(loc_l: torch.Tensor, H: int, W: int):
    """loc_l (..., 2) -> (fx, fy, [(xi, yi, bilinear weight)] for the 4
    corners in the order (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1))."""
    x = loc_l[..., 0] * W - 0.5
    y = loc_l[..., 1] * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    return fx, fy, [(x0i, y0i, (1 - fx) * (1 - fy)), (x0i + 1, y0i, fx * (1 - fy)),
                    (x0i, y0i + 1, (1 - fx) * fy), (x0i + 1, y0i + 1, fx * fy)]


def _bilinear_sample_level(value_l: torch.Tensor, loc: torch.Tensor, H: int,
                           W: int) -> torch.Tensor:
    """value_l (B, H*W, M, D), loc (B, Lq, M, P, 2) -> (B, Lq, M, P, D)."""
    B, _, M, D = value_l.shape
    Lq, P = loc.shape[1], loc.shape[3]
    v = value_l.permute(0, 2, 1, 3)                               # (B, M, HW, D)
    out = None
    for xi, yi, wgt in _corners(loc, H, W)[2]:
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        flat = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)        # (B, Lq, M, P)
        idx = flat.permute(0, 2, 1, 3).reshape(B, M, Lq * P, 1).expand(-1, -1, -1, D)
        g = torch.gather(v, 2, idx).reshape(B, M, Lq, P, D).permute(0, 2, 1, 3, 4)
        tap = g * (wgt * inside.to(value_l.dtype))[..., None]
        out = tap if out is None else out + tap
    return out


def ms_deform_attn_ref(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                       sampling_locations: torch.Tensor,
                       attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain version: gather-based bilinear sampling per level, summed with
    the attention weights."""
    B, S, M, D = value.shape
    Lq = sampling_locations.shape[1]
    out = None
    start = 0
    for lid, (H, W) in enumerate(spatial_shapes):
        samp = _bilinear_sample_level(value[:, start:start + H * W],
                                      sampling_locations[:, :, :, lid], H, W)
        o = (samp * attention_weights[:, :, :, lid, :, None]).sum(dim=3)
        out = o if out is None else out + o
        start += H * W
    return out.reshape(B, Lq, M * D)


def _bf16_tap_rows(loc_l: torch.Tensor, aw_l: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The Pallas kernel's dense row A at acc_dtype bf16, (B, Lq, M, H*W) f32
    holding bf16 values: each tap weight (bilinear corner weight x attention
    weight) formed in f32 and rounded to bf16, the rounded weights of the
    taps on each pixel summed in f32 in tap order (point-major, then
    corner), the sum rounded to bf16 again (ops/msda.py:133, :202-206)."""
    B, Lq, M, P = aw_l.shape
    _, _, corners = _corners(loc_l, H, W)                           # (B, Lq, M, P) each
    a = torch.zeros(B, Lq, M, H * W, dtype=torch.float32, device=loc_l.device)
    for p in range(P):
        for xi, yi, bw in corners:
            xi, yi = xi[..., p], yi[..., p]
            inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            w = (bw[..., p] * aw_l[..., p]).to(torch.bfloat16).float() * inside
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))[..., None]
            a.scatter_add_(3, idx, w[..., None])
    return a.to(torch.bfloat16).float()


def ms_deform_attn_bf16_ref(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain K3-bf16: bf16 value and attention weights, f32 locations ->
    bf16 (B, Lq, M * D), with the rounding points of the JAX package's
    `_msda_pallas_fwd` at bf16 (ops/msda.py:133, :202-206, :224, :252): per
    level the dense row A of `_bf16_tap_rows`, A V accumulated in f32 over
    the bf16 values, the levels summed in f32 and the output rounded to
    bf16."""
    B, S, M, D = value.shape
    Lq = sampling_locations.shape[1]
    loc, aw_all = sampling_locations.float(), attention_weights.float()
    out = None
    start = 0
    for lid, (H, W) in enumerate(spatial_shapes):
        a = _bf16_tap_rows(loc[:, :, :, lid], aw_all[:, :, :, lid], H, W)
        o = torch.einsum("bqms,bsmd->bqmd", a, value[:, start:start + H * W].float())
        out = o if out is None else out + o
        start += H * W
    return out.to(torch.bfloat16).reshape(B, Lq, M * D)


def ms_deform_attn_bwd_bf16_ref(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                                sampling_locations: torch.Tensor,
                                attention_weights: torch.Tensor, grad_out: torch.Tensor):
    """Plain K4-bf16: the backward of `ms_deform_attn_bf16_ref` with the
    rounding points of the JAX package's `_msda_pallas_bwd` at acc_dtype
    bf16 (ops/msda.py:377-418): dValue = A^T g with A of `_bf16_tap_rows`
    and the bf16 g, accumulated in f32 and rounded to bf16; the tap-weight
    gradient dw = <g, V[corner]> of the bf16 rows in f32 (0 for a dead
    corner); then in f32 on the unrounded attention weights and bilinear
    weights, dAttw = sum_c w_c dw_c, rounded to bf16, and dLoc through the
    bilinear weights, f32. Returns (dValue, dLoc, dAttw) in the primal
    dtypes (bf16, f32, bf16)."""
    B, S, M, D = value.shape
    Lq = sampling_locations.shape[1]
    loc, aw_all = sampling_locations.float(), attention_weights.float()
    vf = value.float()
    g = grad_out.float().reshape(B, Lq, M, D)
    dvalue = torch.empty(B, S, M, D, dtype=torch.float32, device=value.device)
    dloc = torch.zeros_like(loc)
    dattw = torch.zeros_like(aw_all)
    bidx = torch.arange(B, device=value.device)[:, None, None, None]
    midx = torch.arange(M, device=value.device)[None, None, :, None]
    start = 0
    for lid, (H, W) in enumerate(spatial_shapes):
        aw = aw_all[:, :, :, lid]                                  # (B, Lq, M, P)
        a = _bf16_tap_rows(loc[:, :, :, lid], aw, H, W)
        dvalue[:, start:start + H * W] = torch.einsum("bqms,bqmd->bsmd", a, g)
        fx, fy, corners = _corners(loc[:, :, :, lid], H, W)
        dw = []
        for xi, yi, _ in corners:
            live = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).float()
            flat = start + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
            index = (bidx.expand_as(flat), flat, midx.expand_as(flat))
            dw.append((vf[index] * g[:, :, :, None]).sum(-1) * live)
        dattw[:, :, :, lid] = sum(c[2] * d for c, d in zip(corners, dw))
        d0, d1, d2, d3 = (aw * d for d in dw)
        dloc[:, :, :, lid, :, 0] = (-(1 - fy) * d0 + (1 - fy) * d1 - fy * d2 + fy * d3) * W
        dloc[:, :, :, lid, :, 1] = (-(1 - fx) * d0 - fx * d1 + (1 - fx) * d2 + fx * d3) * H
        start += H * W
    return dvalue.to(torch.bfloat16), dloc, dattw.to(torch.bfloat16)


def ms_deform_attn_bwd_ref(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                           sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                           grad_out: torch.Tensor):
    """Plain backward with explicit formulas (those of the JAX package's
    `_msda_pallas_bwd`, ops/msda.py:391-418): per live corner tap,
    dValue[corner] += attw * w_corner * g and dw = <g, V[corner]>; a dead
    corner (outside its map) contributes nothing. dw then chains to
    dAttw = sum_c w_c dw_c and, through the bilinear weights, to dLoc.
    Returns (dValue, dLoc, dAttw)."""
    B, S, M, D = value.shape
    Lq = sampling_locations.shape[1]
    g = grad_out.reshape(B, Lq, M, 1, D)
    dvalue = torch.zeros_like(value)
    dloc = torch.zeros_like(sampling_locations)
    dattw = torch.zeros_like(attention_weights)
    bidx = torch.arange(B, device=value.device)[:, None, None, None]
    midx = torch.arange(M, device=value.device)[None, None, :, None]
    start = 0
    for lid, (H, W) in enumerate(spatial_shapes):
        aw = attention_weights[:, :, :, lid]                       # (B, Lq, M, P)
        fx, fy, corners = _corners(sampling_locations[:, :, :, lid], H, W)
        dw = []
        for xi, yi, wgt in corners:
            live = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).to(value.dtype)
            flat = start + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
            index = (bidx.expand_as(flat), flat, midx.expand_as(flat))
            dw.append((value[index] * g).sum(-1) * live)
            dvalue.index_put_(index, (aw * wgt * live)[..., None] * g, accumulate=True)
        dattw[:, :, :, lid] = sum(c[2] * d for c, d in zip(corners, dw))
        d0, d1, d2, d3 = (aw * d for d in dw)
        dfx = -(1 - fy) * d0 + (1 - fy) * d1 - fy * d2 + fy * d3
        dfy = -(1 - fx) * d0 - fx * d1 + (1 - fx) * d2 + fx * d3
        dloc[:, :, :, lid, :, 0] = dfx * W
        dloc[:, :, :, lid, :, 1] = dfy * H
        start += H * W
    return dvalue, dloc, dattw


#: dynamic shared memory a block may use on the H100 (227 KB, after
#: cudaFuncSetAttribute); csrc/msda_common.cuh holds the same number
SMEM_MAX = 232_448
#: the staged kernels' per-warp corner tables, after the value rows: 32
#: warps of 32 entries of 8 bytes in K3, of 16 in K4
FWD_TABLE_BYTES, BWD_TABLE_BYTES = 32 * 32 * 8, 32 * 16 * 8
#: the bf16 tap kernels (csrc/msda_tap.cuh): 64 channels, query tiles of
#: 64 rows, 64-pixel column blocks of 8 KB, 2 or 4 points a level (a row's
#: points in consecutive lanes, which trade their taps by shuffles); the
#: forward takes at most 4 levels, the backward levels of at most 6 blocks
#: (its two warpgroups' dV registers) in a fixed 217,088 B of shared memory
TAP_D, TAP_ROWS, TAP_BLOCK_BYTES, TAP_POINTS = 64, 64, 8192, (2, 4)
TAP_FWD_MAX_LEVELS, TAP_BWD_MAX_BLOCKS = 4, 6
TAP_BWD_SMEM = (2 * TAP_BWD_MAX_BLOCKS * TAP_BLOCK_BYTES + 2 * TAP_BLOCK_BYTES
                + 4 * 64 * (64 * TAP_BWD_MAX_BLOCKS + 8) + 256 * 4 + 1024)


class MsdaPlan(NamedTuple):
    """The kernels K3 and K4 (or K3-bf16 and K4-bf16) launch at one shape.

    fwd: f32 "staged" (one block per (b, m) with value[b, :, m, :] in
    shared memory) or "gather" (one warp per (b, q, m) reading device
    memory); bf16 "tap" (the tap-matrix kernel) or "gather";
    fwd_smem: a staged or tap block's dynamic shared memory in bytes (0 for
    gather);
    bwd: per level, f32 "staged" (one block per (b, m, level) with the value
    slice and its dValue accumulator in shared memory), bf16 "tap" (one
    block per (b, m, level), the tap-matrix kernel), or "direct" (one warp
    per (b, q, m), global atomics into a zeroed dValue slice);
    bwd_smem: a staged or tap block's dynamic shared memory (0 if no level
    takes one);
    fwd_tiles: the forward tap kernel's query tiles of 64 rows a block (0
    unless fwd is "tap")."""
    fwd: str
    fwd_smem: int
    bwd: Tuple[str, ...]
    bwd_smem: int
    fwd_tiles: int = 0


def tap_fwd_smem(spatial_shapes: Sequence[Tuple[int, int]]) -> int:
    """Dynamic shared memory of K3-bf16's tap kernel (csrc/msda.cu
    `tap_fwd_layout`): each level's value rows padded to 32 (128 bytes a
    row) and its tap tile of 64-pixel blocks, a zero block, one
    warpgroup's f32 output tile (16 KB), 4 bytes a thread of scratch, 1024
    bytes to align the base."""
    sizes = [h * w for h, w in spatial_shapes]
    return (sum(128 * -(-s // 32) * 32 + -(-s // 64) * TAP_BLOCK_BYTES for s in sizes)
            + TAP_BLOCK_BYTES + 128 * 32 * 4 + 256 * 4 + 1024)


def msda_plan(B: int, M: int, D: int, spatial_shapes: Sequence[Tuple[int, int]],
              n_sm: int, itemsize: int = 4, Lq: int | None = None,
              P: int | None = None) -> MsdaPlan:
    """Choose K3's and K4's kernels by shape (never on failure).

    f32 (itemsize 4). K3 stages when all levels' rows of one (b, m) and the
    corner tables fit in shared memory (4*S*D + 8192 <= SMEM_MAX: S <= 876
    at D 64) and the B*M blocks fill at least half of the n_sm SMs: the
    training shape (B 16, M 8: 128 blocks). Fewer pairs (the tracking
    shape, B 1: 8 blocks) gather instead. K4 stages each level whose value
    slice, dValue accumulator and corner tables fit (8*S_l*D + 4096 <=
    SMEM_MAX: S_l <= 446 at D 64) and D is even (its lanes hold channel
    pairs); other levels go direct. The number of points does not enter:
    the staged kernels take points in groups.

    bf16 (itemsize 2; Lq and P required). The tap kernels take D 64 and 2
    or 4 points (a thread holds a level's 4P taps of a query). K3-bf16
    takes its tap kernel for at most 4 levels whose value rows and tap
    tiles fit (`tap_fwd_smem`: 215,040 B at the recipe's two 18x18 levels;
    S_l <= 384 at two equal levels), else it gathers. Its blocks walk the
    query tiles of one (b, m) where the B*M pairs fill half the card (B 12
    and 16 at M 8 on 132 SMs); fewer pairs split the ceil(Lq / 64) tiles
    over ceil(n_sm / (B*M)) blocks each at most (B 1: one tile a block, 88
    blocks; B 4: three, 128 blocks). K4-bf16 takes its tap kernel for each
    level of at most 6 blocks of 64 pixels (S_l <= 384; TAP_BWD_SMEM), its
    direct kernel for the others."""
    if itemsize == 2:
        if Lq is None or P is None:
            raise TypeError("msda_plan at itemsize 2 needs Lq and P")
        tap = D == TAP_D and P in TAP_POINTS
        fwd_smem = tap_fwd_smem(spatial_shapes)
        fwd_tap = tap and len(spatial_shapes) <= TAP_FWD_MAX_LEVELS and fwd_smem <= SMEM_MAX
        tiles = 0
        if fwd_tap:
            n_tiles = max(1, -(-Lq // TAP_ROWS))
            pairs = B * M
            per_pair = 1 if 2 * pairs >= n_sm else min(n_tiles, -(-n_sm // pairs))
            tiles = -(-n_tiles // per_pair)
        bwd = tuple("tap" if tap and h * w <= 64 * TAP_BWD_MAX_BLOCKS else "direct"
                    for h, w in spatial_shapes)
        bwd_smem = TAP_BWD_SMEM if "tap" in bwd else 0
        return MsdaPlan("tap" if fwd_tap else "gather", fwd_smem if fwd_tap else 0, bwd,
                        bwd_smem, tiles)
    if itemsize != 4:
        raise ValueError(f"msda_plan: itemsize 4 (f32) or 2 (bf16), got {itemsize}")
    S = sum(h * w for h, w in spatial_shapes)
    fwd_smem = -(-4 * S * D // 8) * 8 + FWD_TABLE_BYTES
    staged = fwd_smem <= SMEM_MAX and 2 * B * M >= n_sm

    def bwd_bytes(h, w):
        return 8 * h * w * D + BWD_TABLE_BYTES

    bwd = tuple("staged" if bwd_bytes(h, w) <= SMEM_MAX and D % 2 == 0 else "direct"
                for h, w in spatial_shapes)
    bwd_smem = max((bwd_bytes(h, w) for (h, w), path in zip(spatial_shapes, bwd)
                    if path == "staged"), default=0)
    return MsdaPlan("staged" if staged else "gather", fwd_smem if staged else 0, bwd,
                    bwd_smem)


def _plan_for(value: torch.Tensor, spatial_shapes, loc: torch.Tensor) -> MsdaPlan:
    B, _, M, D = value.shape
    n_sm = torch.cuda.get_device_properties(value.device).multi_processor_count
    return msda_plan(B, M, D, spatial_shapes, n_sm, value.element_size(), Lq=loc.shape[1],
                     P=loc.shape[4])


def _check_kernel_args(value, spatial_shapes, loc, attw, grad_out=None,
                       value_dtype=torch.float32):
    tensors = [("value", value), ("sampling_locations", loc), ("attention_weights", attw)]
    if grad_out is not None:
        tensors.append(("grad_out", grad_out))
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"ms_deform_attn: {name} is on {t.device}; all inputs "
                             f"must be CPU or all CUDA tensors")
        want = torch.float32 if name == "sampling_locations" else value_dtype
        if t.dtype != want:
            raise TypeError(f"ms_deform_attn kernel takes {want} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ms_deform_attn kernel takes contiguous {name}")
        if t.device != value.device:
            raise ValueError(f"ms_deform_attn: {name} on {t.device}, value on {value.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"ms_deform_attn kernel takes 16-byte aligned {name}")
    if value.dim() != 4:
        raise ValueError(f"ms_deform_attn: value must be (B, S, M, D), is {tuple(value.shape)}")
    B, S, M, D = value.shape
    L = len(spatial_shapes)
    if loc.dim() != 6 or loc.shape[0] != B or loc.shape[2] != M or loc.shape[3] != L \
            or loc.shape[5] != 2:
        raise ValueError(f"ms_deform_attn: sampling_locations {tuple(loc.shape)} does not "
                         f"match value {tuple(value.shape)} with {L} levels")
    if tuple(attw.shape) != tuple(loc.shape[:5]):
        raise ValueError(f"ms_deform_attn: attention_weights {tuple(attw.shape)} != "
                         f"{tuple(loc.shape[:5])}")
    if grad_out is not None and tuple(grad_out.shape) != (B, loc.shape[1], M * D):
        raise ValueError(f"ms_deform_attn: grad_out {tuple(grad_out.shape)} != "
                         f"{(B, loc.shape[1], M * D)}")
    if sum(h * w for h, w in spatial_shapes) != S or not 1 <= L <= 8 or not 1 <= D <= 128:
        raise ValueError(f"ms_deform_attn kernel: levels {spatial_shapes} must cover "
                         f"S={S}, 1 <= L <= 8 and 1 <= D <= 128 (D={D})")


def _shapes_arg(spatial_shapes):
    return (ctypes.c_int * (2 * len(spatial_shapes)))(
        *[int(s) for hw in spatial_shapes for s in hw])


def ms_deform_attn_fwd(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                       sampling_locations: torch.Tensor,
                       attention_weights: torch.Tensor) -> torch.Tensor:
    """Forward without autograd: kernel K3 for CUDA tensors (its staged or
    gather kernel, as `msda_plan` picks; each launch counted in
    `ms_deform_attn.launches` and, by kernel, in
    `ms_deform_attn.launches_by_kernel`), `ms_deform_attn_ref` for CPU
    tensors."""
    tensors = (value, sampling_locations, attention_weights)
    if all(t.device.type == "cpu" for t in tensors):
        return ms_deform_attn_ref(value, spatial_shapes, sampling_locations,
                                  attention_weights)
    _check_kernel_args(value, spatial_shapes, sampling_locations, attention_weights)
    B, S, M, D = value.shape
    Lq, L, P = sampling_locations.shape[1], sampling_locations.shape[3], \
        sampling_locations.shape[4]
    plan = _plan_for(value, spatial_shapes, sampling_locations)
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    lib = _build.library("msda")
    err = _build.launch(value.device, lib.msda_fwd_f32,
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(),
        B, S, M, D, Lq, L, P, _shapes_arg(spatial_shapes),
        int(plan.fwd == "staged"),
        torch.cuda.current_stream(value.device).cuda_stream)
    _build.check(err, "msda_fwd_f32")
    _build.count_launch(ms_deform_attn, value.device, (plan.fwd,))
    return out


def ms_deform_attn_bwd(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                       sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                       grad_out: torch.Tensor):
    """(dValue, dLoc, dAttw): kernel K4 for CUDA tensors (its staged kernel
    for the levels `msda_plan` stages, its direct kernel for the others;
    each call counted once in `ms_deform_attn_bwd.launches`),
    `ms_deform_attn_bwd_ref` for CPU tensors. K4 sums dValue with atomics
    (in shared memory for staged levels, in device memory for direct ones),
    so its summation order varies from run to run."""
    tensors = (value, sampling_locations, attention_weights, grad_out)
    if all(t.device.type == "cpu" for t in tensors):
        return ms_deform_attn_bwd_ref(value, spatial_shapes, sampling_locations,
                                      attention_weights, grad_out)
    _check_kernel_args(value, spatial_shapes, sampling_locations, attention_weights, grad_out)
    B, S, M, D = value.shape
    Lq, L, P = sampling_locations.shape[1], sampling_locations.shape[3], \
        sampling_locations.shape[4]
    plan = _plan_for(value, spatial_shapes, sampling_locations)
    # a staged level's dValue slice is written whole by its block; a direct
    # level's is summed with global atomics and zeroed first
    dvalue = torch.empty_like(value)
    start = 0
    for (h, w), path in zip(spatial_shapes, plan.bwd):
        if path == "direct":
            dvalue[:, start:start + h * w].zero_()
        start += h * w
    dloc = torch.empty_like(sampling_locations)
    dattw = torch.empty_like(attention_weights)
    lib = _build.library("msda_bwd")
    err = _build.launch(value.device, lib.msda_bwd_f32,
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), grad_out.data_ptr(),
        dvalue.data_ptr(), dloc.data_ptr(), dattw.data_ptr(),
        B, S, M, D, Lq, L, P, _shapes_arg(spatial_shapes),
        sum(1 << l for l, path in enumerate(plan.bwd) if path == "staged"),
        torch.cuda.current_stream(value.device).cuda_stream)
    _build.check(err, "msda_bwd_f32")
    _build.count_launch(ms_deform_attn_bwd, value.device)
    return dvalue, dloc, dattw


def ms_deform_attn_bf16(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """bf16 forward without autograd: kernel K3-bf16 for CUDA tensors (its
    tap or gather kernel, as `msda_plan` picks at bf16; each launch counted
    in `ms_deform_attn_bf16.launches` and by kernel in
    `ms_deform_attn_bf16.launches_by_kernel`), `ms_deform_attn_bf16_ref` for
    CPU tensors. value and attention_weights must be bf16 and
    sampling_locations f32; the kernel takes D a multiple of 8 up to 128
    and raises on other shapes."""
    for name, t, want in (("value", value, torch.bfloat16),
                          ("sampling_locations", sampling_locations, torch.float32),
                          ("attention_weights", attention_weights, torch.bfloat16)):
        if t.dtype != want:
            raise TypeError(f"ms_deform_attn_bf16 takes {want} {name}, got {t.dtype}")
    tensors = (value, sampling_locations, attention_weights)
    if all(t.device.type == "cpu" for t in tensors):
        return ms_deform_attn_bf16_ref(value, spatial_shapes, sampling_locations,
                                       attention_weights)
    _check_kernel_args(value, spatial_shapes, sampling_locations, attention_weights,
                       value_dtype=torch.bfloat16)
    B, S, M, D = value.shape
    if D % 8:
        raise ValueError(f"ms_deform_attn_bf16 kernel takes D a multiple of 8, got {D}")
    Lq, L, P = sampling_locations.shape[1], sampling_locations.shape[3], \
        sampling_locations.shape[4]
    plan = _plan_for(value, spatial_shapes, sampling_locations)
    out = torch.empty((B, Lq, M * D), dtype=torch.bfloat16, device=value.device)
    lib = _build.library("msda")
    err = _build.launch(value.device, lib.msda_fwd_bf16,
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(),
        B, S, M, D, Lq, L, P, _shapes_arg(spatial_shapes), plan.fwd_tiles,
        torch.cuda.current_stream(value.device).cuda_stream)
    _build.check(err, "msda_fwd_bf16")
    _build.count_launch(ms_deform_attn_bf16, value.device, (plan.fwd,))
    return out


def ms_deform_attn_bwd_bf16(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                            sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                            grad_out: torch.Tensor):
    """bf16 (dValue, dLoc, dAttw), in the primal dtypes (bf16, f32, bf16):
    kernel K4-bf16 for CUDA tensors (its tap kernel for the levels
    `msda_plan` gives it at bf16, its direct kernel into an f32 scratch for
    the others, rounded to bf16 here; each call counted once in
    `ms_deform_attn_bwd_bf16.launches`, each kernel it launches in
    `ms_deform_attn_bwd_bf16.launches_by_kernel`), `ms_deform_attn_bwd_bf16_ref`
    for CPU tensors. value, attention_weights and grad_out bf16,
    sampling_locations f32; the kernel takes D a multiple of 8 up to 128.
    The tap kernel sums dValue in a fixed order without atomics, so the
    levels it takes give the same bits from run to run; the direct
    kernel's atomics do not."""
    for name, t, want in (("value", value, torch.bfloat16),
                          ("sampling_locations", sampling_locations, torch.float32),
                          ("attention_weights", attention_weights, torch.bfloat16),
                          ("grad_out", grad_out, torch.bfloat16)):
        if t.dtype != want:
            raise TypeError(f"ms_deform_attn_bwd_bf16 takes {want} {name}, got {t.dtype}")
    tensors = (value, sampling_locations, attention_weights, grad_out)
    if all(t.device.type == "cpu" for t in tensors):
        return ms_deform_attn_bwd_bf16_ref(value, spatial_shapes, sampling_locations,
                                           attention_weights, grad_out)
    _check_kernel_args(value, spatial_shapes, sampling_locations, attention_weights, grad_out,
                       value_dtype=torch.bfloat16)
    B, S, M, D = value.shape
    if D % 8:
        raise ValueError(f"ms_deform_attn_bwd_bf16 kernel takes D a multiple of 8, got {D}")
    Lq, L, P = sampling_locations.shape[1], sampling_locations.shape[3], \
        sampling_locations.shape[4]
    plan = _plan_for(value, spatial_shapes, sampling_locations)
    dvalue = torch.empty_like(value)
    # a direct level scatters into an f32 scratch with global atomics (a bf16
    # atomic would round at every add), zeroed first and rounded afterwards
    direct = [(start, start + h * w) for start, (h, w), path in
              zip(_level_starts(spatial_shapes), spatial_shapes, plan.bwd) if path == "direct"]
    scratch = torch.zeros(value.shape, dtype=torch.float32, device=value.device) \
        if direct else None
    dloc = torch.empty_like(sampling_locations)
    dattw = torch.empty_like(attention_weights)
    lib = _build.library("msda_bwd")
    err = _build.launch(value.device, lib.msda_bwd_bf16,
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), grad_out.data_ptr(),
        dvalue.data_ptr(), scratch.data_ptr() if direct else None,
        dloc.data_ptr(), dattw.data_ptr(),
        B, S, M, D, Lq, L, P, _shapes_arg(spatial_shapes),
        sum(1 << l for l, path in enumerate(plan.bwd) if path == "tap"),
        torch.cuda.current_stream(value.device).cuda_stream)
    _build.check(err, "msda_bwd_bf16")
    for s0, s1 in direct:
        dvalue[:, s0:s1].copy_(scratch[:, s0:s1])
    _build.count_launch(ms_deform_attn_bwd_bf16, value.device, sorted(set(plan.bwd)))
    return dvalue, dloc, dattw


def _level_starts(spatial_shapes):
    starts, s = [], 0
    for h, w in spatial_shapes:
        starts.append(s)
        s += h * w
    return starts


class _MSDeformAttn(torch.autograd.Function):
    """K3 forward and K4 backward, or with `bf16` K3-bf16 and K4-bf16."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights, bf16):
        ctx.spatial_shapes, ctx.bf16 = spatial_shapes, bf16
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        fwd = ms_deform_attn_bf16 if bf16 else ms_deform_attn_fwd
        return fwd(value, spatial_shapes, sampling_locations, attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attw = ctx.saved_tensors
        bwd = ms_deform_attn_bwd_bf16 if ctx.bf16 else ms_deform_attn_bwd
        dvalue, dloc, dattw = bwd(value, ctx.spatial_shapes, loc, attw, grad_out.contiguous())
        return dvalue, None, dloc, dattw, None


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention core (see module docstring),
    differentiable in value, sampling_locations and attention_weights: K3
    forward and K4 backward on CUDA tensors, the plain versions on CPU
    tensors. spatial_shapes is not differentiated. Without a gradient to
    take (inference) it skips the autograd Function's per-call cost. A bf16
    value goes to `ms_deform_attn_bf16`, and under autograd to K3-bf16 and
    K4-bf16."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    tensors = (value, sampling_locations, attention_weights)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    bf16 = value.dtype == torch.bfloat16
    if grad:
        return _MSDeformAttn.apply(value, shapes, sampling_locations, attention_weights, bf16)
    if bf16:
        return ms_deform_attn_bf16(value, shapes, sampling_locations, attention_weights)
    return ms_deform_attn_fwd(value, shapes, sampling_locations, attention_weights)


ms_deform_attn.launches = 0
#: K3 launches by the kernel `msda_plan` picked ("staged" or "gather")
ms_deform_attn.launches_by_kernel = {"staged": 0, "gather": 0}
ms_deform_attn_bf16.launches = 0
#: K3-bf16 launches by the kernel `msda_plan` picked ("tap" or "gather")
ms_deform_attn_bf16.launches_by_kernel = {"tap": 0, "gather": 0}
ms_deform_attn_bwd.launches = 0
ms_deform_attn_bwd_bf16.launches = 0
#: K4-bf16's kernel launches: a call launches "tap" if msda_plan gives a
#: level the tap kernel, "direct" if it gives one the direct kernel
ms_deform_attn_bwd_bf16.launches_by_kernel = {"tap": 0, "direct": 0}
