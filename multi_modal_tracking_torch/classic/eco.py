"""ECO: the factorised-convolution correlation-filter tracker, the port's
counterpart of the JAX package's `classic/eco.py` (pytracking's ECO).

Feature banks ('handcrafted', 'conv1' and 'layer3' of one ResNet-18, or a
custom feature_fn) each keep a learned (C, Cp) projection, PCA-initialised
from the init frame and optimised jointly with the filter by Gauss-Newton
CG under accept/reject Levenberg-Marquardt damping; the banks' score
spectra are Fourier-upsampled to the finest grid and summed with their
weights; the sample memory replaces its lightest sample and recentres the
new one in the Fourier domain; every update_interval frames the filters
take num_cg_iter CG steps on the weighted normal equations. The spatial
regulariser is `dcf.reg_window` applied in the spatial domain.

The eigendecomposition of the PCA init is `torch.linalg.eigh` (cuSOLVER on
the card, at init only). An eigenvector's sign is the library's choice, as
in the JAX package; the joint objective is invariant under P -> P R,
f -> R^T f for a diagonal R of signs, so scores and boxes do not depend on
it, and P matches the JAX package's only up to column signs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multi_modal_tracking_torch.classic.augmentation import (ECO_AUGMENTATION, Draw,
                                                             InitAugmenter, TorchDraws)
from multi_modal_tracking_torch.classic.common import (box_xywh, center_box, down2, fetch,
                                                       init_state, take, upload_image)
from multi_modal_tracking_torch.classic.dimpnet import (classic_backbone, init_like_flax,
                                                        load_resnet)
from multi_modal_tracking_torch.classic.dcf import (const, fft2, gauss_label_2d, hann2d, ifft2,
                                                    max2d, pad_rfft2, reg_window, subpixel_peak)
from multi_modal_tracking_torch.classic.optimization import (conjugate_gradient,
                                                             solve_normal_equations)
from multi_modal_tracking_torch.ops.crop import crop_resize, normalize_imagenet
from multi_modal_tracking_torch.utils.device import resolve_device, set_precision

# per bank (output_sigma_factor, learning_rate, translation weight) when
# several banks run together (parameter/eco/default.py)
_MULTI_BANK_DEFAULTS = {
    "handcrafted": (1.0 / 16, 0.025, 0.4),
    "conv1": (1.0 / 16, 0.025, 0.4),
    "layer3": (1.0 / 4, 0.0075, 0.6),
}

# per bank (reg_window_min, reg_window_edge, reg_sparsity_threshold)
_REG_WINDOW_DEFAULTS = {
    "handcrafted": (1e-4, 10e-3, 0.05),
    "conv1": (1e-4, 10e-3, 0.05),
    "custom": (1e-4, 10e-3, 0.05),
    "layer3": (10e-4, 50e-3, 0.1),
}


def default_features(patch: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) float patches in [0, 1] -> (..., 6, H/4, W/4): the
    colour channels, grey, |dx| and |dy|, mean-pooled over 4x4 cells,
    each channel's mean removed (a dependency-free stand-in for HOG/CN)."""
    gray = patch.mean(dim=-1)
    dy = torch.abs(torch.diff(gray, dim=-2, prepend=gray[..., :1, :]))
    dx = torch.abs(torch.diff(gray, dim=-1, prepend=gray[..., :, :1]))
    feats = torch.cat([patch.movedim(-1, -3), gray[..., None, :, :], dx[..., None, :, :],
                       dy[..., None, :, :]], dim=-3)
    *lead, C, H, W = feats.shape
    cell = 4
    f = feats.reshape(*lead, C, H // cell, cell, W // cell, cell).mean(dim=(-3, -1))
    return f - f.mean(dim=(-2, -1), keepdim=True)


def fourier_shift(xf: torch.Tensor, shift_yx: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Translate rfft2-domain samples (..., h, w//2+1) so that content at
    +shift (feature px (dy, dx); (..., 2) for a batch) moves to the origin:
    multiply by e^{+i w . shift}."""
    dev = xf.device
    ky = torch.fft.fftfreq(h, device=dev)[:, None]
    kx = torch.fft.rfftfreq(w, device=dev)[None, :]
    s = shift_yx[..., None, None, :]
    phase = torch.exp(2j * np.pi * (ky * s[..., 0] + kx * s[..., 1]))
    return xf * phase


class ECOState(NamedTuple):
    filter_f: Tuple[torch.Tensor, ...]   # per bank (Cp, h, w//2+1)
    proj: Tuple[torch.Tensor, ...]       # per bank (C, Cp)
    samples_f: Tuple[torch.Tensor, ...]  # per bank (K, Cp, h, w//2+1)
    weights: Tuple[torch.Tensor, ...]    # per bank (K,)
    prev_ind: Tuple[torch.Tensor, ...]   # per bank int64 0-d (-1: none yet)
    yf: Tuple[torch.Tensor, ...]         # per bank (h, w//2+1) label spectrum
    reg_w: Tuple[torch.Tensor, ...]      # per bank (h, w) spatial penalty window
    center: torch.Tensor                 # (2,) target centre (y, x), image px
    target_sz: torch.Tensor              # (2,) target (h, w), image px


@dataclasses.dataclass
class _Bank:
    name: str
    sigma_factor: float
    learning_rate: float
    weight: float
    feat_c: int = 0
    feat_sz: int = 0
    cdim: int = 0


@dataclasses.dataclass
class ECOTracker:
    """The host API (initialize / track) over the device steps; the
    fields are the JAX package's, plus `device` (CUDA unless "cpu") and
    `draw` (the random-draw hook; None: TorchDraws from rng_seed).
    features: '+'-joined bank names ('handcrafted', 'conv1', 'layer3');
    'conv1+layer3' is the reference's shallow + deep default. A custom
    feature_fn ((H, W, 3) patch in [0, 1] -> (C, h, w)) makes one bank."""
    search_factor: float = 4.0
    crop_size: int = 224
    output_sigma_factor: float = 1. / 12
    use_reg_window: bool = True
    reg: float = 0.05
    learning_rate: float = 0.012
    num_cg_iter: int = 5
    scale_factors: Tuple[float, ...] = (0.97, 1.0, 1.03)
    update_interval: int = 5
    features: str = "handcrafted"
    rng_seed: int = 0
    feature_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    compressed_dim: Optional[int] = None
    update_projection: bool = True
    projection_reg: float = 5e-8
    init_gn_iter: int = 10
    init_cg_per_gn: int = 10
    sample_memory_size: int = 50
    augmentation: Optional[dict] = None
    random_shift_factor: float = 0.0
    device: str = "cuda"
    draw: Optional[Draw] = None

    DRAW_OFFSETS = {"dropout": 2}

    def __post_init__(self):
        self.device = resolve_device(self.device)
        set_precision(torch.float32)
        names = ["custom"] if self.feature_fn is not None else self.features.split("+")
        self.banks: List[_Bank] = []
        for n in names:
            if n not in ("handcrafted", "conv1", "layer3", "custom"):
                raise ValueError(f"unknown features '{n}'")
            if len(names) == 1:
                osf, lr, wt = self.output_sigma_factor, self.learning_rate, 1.0
            elif n in _MULTI_BANK_DEFAULTS:
                osf, lr, wt = _MULTI_BANK_DEFAULTS[n]
            else:
                raise ValueError(f"unknown bank '{n}' in multi-bank mode")
            self.banks.append(_Bank(n, osf, lr, wt))
        if any(b.name in ("conv1", "layer3") for b in self.banks):
            self.backbone = classic_backbone("resnet18")
            init_like_flax(self.backbone, torch.Generator().manual_seed(self.rng_seed))
            self.backbone.to(self.device).eval().requires_grad_(False)
        self._last = "layer3" if any(b.name == "layer3" for b in self.banks) else "conv1"
        for b in self.banks:
            b.feat_c, b.feat_sz = self._bank_shape(b.name)
            if self.compressed_dim is not None:
                b.cdim = min(self.compressed_dim, b.feat_c)
            elif b.feat_c <= 8:
                b.cdim = max(b.feat_c // 2 + 1, 3)
            elif b.feat_c <= 64:
                b.cdim = 16
            else:
                b.cdim = 64
        self._feat_sz = max(b.feat_sz for b in self.banks)
        self._cell = self.crop_size / self._feat_sz
        self.augmenter = InitAugmenter(
            self.crop_size, spec=ECO_AUGMENTATION if self.augmentation is None
            else self.augmentation, random_shift_factor=self.random_shift_factor,
            seed=self.rng_seed)
        if self.augmenter.num_samples > self.sample_memory_size:
            raise ValueError(f"sample_memory_size={self.sample_memory_size} < augmented "
                             f"init batch {self.augmenter.num_samples}")
        if self.augmenter.num_samples < 5 and self.update_projection:
            # the bilinear joint problem is ill-posed on a near-single sample
            self.update_projection = False
        if self.draw is None:
            self.draw = TorchDraws(self.rng_seed, self.device, self.DRAW_OFFSETS)
        self._scales = torch.tensor(self.scale_factors, dtype=torch.float32, device=self.device)
        self._frame = 0

    def _draw(self, site: str, shape, frame: int) -> torch.Tensor:
        """The draw hook's uniforms on this tracker's device."""
        return self.draw(site, tuple(shape), frame).to(self.device)

    def _bank_shape(self, name: str) -> Tuple[int, int]:
        """(channels, side) of a bank's features on a crop_size crop."""
        if name == "handcrafted":
            return 6, self.crop_size // 4
        if name == "custom":
            f = self.feature_fn(torch.zeros((self.crop_size, self.crop_size, 3),
                                            device=self.device))
            return int(f.shape[0]), int(f.shape[-1])
        s = down2(down2(self.crop_size))
        if name == "conv1":
            return 64, s
        return 256, down2(down2(s))

    # ---------------------------------------------------------------- features
    def _extract(self, crops: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(N, H, W, 3) crops on the 0..255 scale -> per bank (N, C, h, w),
        one backbone forward shared by the deep banks."""
        out = []
        feats = None
        for b in self.banks:
            if b.name in ("conv1", "layer3"):
                if feats is None:
                    feats = self.backbone(normalize_imagenet(crops).permute(0, 3, 1, 2),
                                          last=self._last)
                f = feats[b.name]
                out.append(f - f.mean(dim=(2, 3), keepdim=True))
            elif b.name == "custom":
                out.append(torch.stack([self.feature_fn(c / 255.0) for c in crops]))
            else:
                out.append(default_features(crops / 255.0))
        return tuple(out)

    def load_backbone(self, state_dict) -> None:
        """A torchvision / pytracking ResNet state dict into the deep banks'
        backbone (keys it lacks are skipped)."""
        if not hasattr(self, "backbone"):
            raise ValueError("load_backbone requires a conv1/layer3 bank")
        load_resnet(self.backbone, state_dict)

    # ------------------------------------------------------------ device steps
    def _crops(self, image, center, size, scales) -> Tuple[torch.Tensor, torch.Tensor]:
        """One search_factor x scale crop per scale -> ((S, H, W, 3), image
        px per crop px (S,))."""
        box = center_box(center, size)
        crops, pxs = [], []
        for sc in scales:
            crop, rf = crop_resize(image, box, self.search_factor * sc, self.crop_size)
            crops.append(crop)
            pxs.append(1.0 / rf)
        return torch.stack(crops), torch.stack(pxs)

    @staticmethod
    def _compress(xf: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
        """Project rfft-domain features (..., C, h, wf) -> (..., Cp, h, wf)
        (the projection is spatially linear, so it commutes with the FFT):
        one product with P^T, no transpose of the features."""
        return torch.matmul(proj.t().to(xf.dtype), xf.flatten(-2)).unflatten(-1, xf.shape[-2:])

    def _learn_bank(self, filt, zf, w, yf, reg_w, num_iter):
        """CG on the weighted normal equations over the compressed memory,
        the projection fixed; the spatial window regularises:
        A f = sum_k w_k conj(z_k) (z_k . f) + fft2(W^2 ifft2(f)). The sums
        are products and reductions along one dim (an einsum would copy
        the memory into a transposed layout at every product)."""
        w = w[:, None, None]
        w2 = reg_w * reg_w
        hw = tuple(reg_w.shape)
        zc = torch.conj(zf)

        def A(f):
            resp = torch.sum(zf * f, dim=1)
            return torch.sum((w * resp)[:, None] * zc, dim=0) + fft2(w2[None] * ifft2(f, hw))

        b = torch.sum((w * yf)[:, None] * zc, dim=0)
        return conjugate_gradient(A, b, x0=filt, num_iter=num_iter).x

    def _learn(self, state: ECOState) -> ECOState:
        filt = tuple(self._learn_bank(f, zf, w, yf, rw, self.num_cg_iter)
                     for f, zf, w, yf, rw in zip(state.filter_f, state.samples_f,
                                                 state.weights, state.yf, state.reg_w))
        return state._replace(filter_f=filt)

    def _reg_window_bank(self, bank: _Bank, target_sz: torch.Tensor) -> torch.Tensor:
        """The bank's spatial regularisation window on its feature grid, or
        a flat sqrt(reg) window (the scalar Tikhonov) without use_reg_window."""
        h = w = bank.feat_sz
        if not self.use_reg_window:
            return torch.full((h, w), float(np.sqrt(np.float32(self.reg))), device=self.device)
        wmin, wedge, thr = _REG_WINDOW_DEFAULTS[bank.name]
        # the crop side covers search_factor * sqrt(area) image px
        tgt_feat = target_sz * bank.feat_sz / (self.search_factor * torch.sqrt(target_sz.prod()))
        return reg_window(h, w, tgt_feat, window_min=wmin, window_edge=wedge,
                          sparsity_threshold=thr)

    def _init_bank(self, bank: _Bank, feats: torch.Tensor, reg_w: torch.Tensor):
        """PCA projection, then the damped joint (filter, projection)
        optimisation, then the compressed init samples. feats (A, C, h, w)
        -> (filter, proj, zf0, yf)."""
        A_n, C, h, w = feats.shape
        dev = feats.device
        x_mat = feats.transpose(0, 1).reshape(C, -1)
        x_mat = x_mat - x_mat.mean(dim=1, keepdim=True)
        _, vecs = torch.linalg.eigh(x_mat @ x_mat.T)               # ascending
        proj0 = torch.flip(vecs, (1,))[:, :bank.cdim]             # (C, Cp)

        xf = fft2(feats * hann2d(h, w, device=dev)[None, None])    # (A, C, h, wf)
        # the augmented samples whose transform moved the target recentred
        shifts = torch.from_numpy(self.augmenter.shifts).to(dev) / (self.crop_size / bank.feat_sz)
        xf = fourier_shift(xf, shifts[:, None], h, w)

        sigma = max(bank.feat_sz / self.search_factor * bank.sigma_factor, 1.0)
        y = gauss_label_2d(h, w, sigma, torch.tensor([h / 2.0, w / 2.0], device=dev))
        yf = fft2(torch.fft.ifftshift(y))

        f0 = torch.zeros((bank.cdim, h, w // 2 + 1), dtype=xf.dtype, device=dev)
        sw = float(np.sqrt(np.float32(1.0 / A_n)))
        if not self.update_projection:
            return f0, proj0, self._compress(xf, proj0), yf
        # The joint Gauss-Newton over the bilinear objective, damped
        # Levenberg-Marquardt style: zero-valued residual rows lam * base *
        # (x - x.detach()) damp each linearised solve without changing the
        # objective, and a step is accepted only if the objective fell
        # (else rejected, and lam grows).
        base_p = torch.sqrt(35.0 * (2.0 * torch.sum(torch.abs(yf) ** 2) / C +
                                    self.projection_reg))
        base_f = torch.sqrt(torch.mean(reg_w ** 2))
        sqrt_preg = float(np.sqrt(np.float32(self.projection_reg)))
        hw = tuple(reg_w.shape)

        # every dict in sorted key order: the order in which the JAX
        # package's trees flatten, so that the solvers sum alike
        def residual(v):
            f, P = v["f"], v["P"]
            r = torch.sum(self._compress(xf, P) * f, dim=1) - yf[None]
            return {"data": sw * r, "reg_P": sqrt_preg * P,
                    "reg_f": fft2(reg_w[None] * ifft2(f, hw))}

        def objective(v):
            return sum(torch.sum(torch.abs(r) ** 2) for r in residual(v).values())

        v = {"P": proj0, "f": f0}
        obj_v = objective(v)
        lam = torch.ones((), device=dev)
        for _ in range(self.init_gn_iter):
            def damped(vv, lam=lam):
                return {"damp_P": lam * base_p * (vv["P"] - vv["P"].detach()),
                        "damp_f": lam * base_f * (vv["f"] - vv["f"].detach()),
                        **residual(vv)}

            zf = self._compress(xf, v["P"])

            def jvp_fn(vv, d, lam=lam, zf=zf):
                # the product rule on the bilinear data term, the rest linear
                g = torch.matmul(d["P"].to(xf.dtype), vv["f"].flatten(-2)).unflatten(
                    -1, vv["f"].shape[-2:])
                data = torch.sum(xf * g, dim=1) + torch.sum(zf * d["f"], dim=1)
                return {"damp_P": lam * base_p * d["P"], "damp_f": lam * base_f * d["f"],
                        "data": sw * data, "reg_P": sqrt_preg * d["P"],
                        "reg_f": fft2(reg_w[None] * ifft2(d["f"], hw))}

            v_new = solve_normal_equations(damped, v, num_iter=self.init_cg_per_gn,
                                           jvp_fn=jvp_fn)
            obj_new = objective(v_new)
            ok = obj_new < obj_v
            v = {k: torch.where(ok, v_new[k], v[k]) for k in v}
            obj_v = torch.where(ok, obj_new, obj_v)
            lam = torch.where(ok, torch.clamp(lam * 0.5, min=1.0), lam * 4.0)
        return v["f"], v["P"], self._compress(xf, v["P"]), yf

    def _init_fn(self, image, box) -> ECOState:
        center, target_sz = init_state(box)
        crops, _ = self._crops(image, center, target_sz, (1.0,))
        feats = self._extract(self.augmenter(crops[0]))              # per bank (A_img, C, h, w)
        A_n = self.augmenter.num_samples
        K = self.sample_memory_size
        num = self.augmenter.dropout[0] if self.augmenter.dropout else 0
        filt, proj, samples, weights, yfs, regs, prev = [], [], [], [], [], [], []
        for bank, fb in zip(self.banks, feats):
            fb = self.augmenter.augment_features(
                fb, self._draw("dropout", (num, 1, 1, fb.shape[1]), 0) if num else None)
            reg_w = self._reg_window_bank(bank, target_sz)
            f, P, zf0, yf = self._init_bank(bank, fb, reg_w)
            mem = zf0.new_zeros((K,) + tuple(zf0.shape[1:]))
            mem[:A_n] = zf0
            wts = torch.zeros(K, device=self.device)
            wts[:A_n] = 1.0 / A_n
            filt.append(f)
            proj.append(P)
            samples.append(mem)
            weights.append(wts)
            yfs.append(yf)
            regs.append(reg_w)
            prev.append(torch.tensor(-1, dtype=torch.int64, device=self.device))
        st = ECOState(filter_f=tuple(filt), proj=tuple(proj), samples_f=tuple(samples),
                      weights=tuple(weights), prev_ind=tuple(prev), yf=tuple(yfs),
                      reg_w=tuple(regs), center=center, target_sz=target_sz)
        if not self.update_projection:
            # a fixed projection still takes the init CG budget
            # (init_gn_iter * init_cg_per_gn), not the per-update one
            init_cg = self.init_gn_iter * self.init_cg_per_gn
            st = st._replace(filter_f=tuple(
                self._learn_bank(f, zf, w, yf, rw, init_cg)
                for f, zf, w, yf, rw in zip(st.filter_f, st.samples_f, st.weights, st.yf,
                                            st.reg_w)))
        return st

    def _scores(self, state: ECOState, feats) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Per-bank features (S, C, h, w) -> fused scores (S, H, W) on the
        finest grid (fftshifted: the centre is zero displacement) and each
        bank's compressed spectra (S, Cp, h, wf)."""
        H = W = self._feat_sz
        score_f = None
        zfs = []
        for bank, fb, P, f in zip(self.banks, feats, state.proj, state.filter_f):
            h = w = bank.feat_sz
            zf = self._compress(fft2(fb * hann2d(h, w, device=fb.device)), P)
            zfs.append(zf)
            # learning solves sum_p zf_p f_p ~ yf, so the response to a new
            # sample is sum_p zf'_p f_p, with no conjugate: the shift theorem
            # then moves the peak by the target's displacement
            sf = pad_rfft2(torch.sum(zf * f, dim=1), (H, W), (h, w))
            score_f = bank.weight * sf if score_f is None else score_f + bank.weight * sf
        s = torch.fft.fftshift(ifft2(score_f, (H, W)), dim=(-2, -1))
        return s, zfs

    def _track_fn(self, state: ECOState, image):
        """Scale-pyramid localisation on the fused score, then each bank's
        recentred sample into its memory (min-weight replacement)."""
        H = W = self._feat_sz
        crops, pxs = self._crops(image, state.center, state.target_sz, self.scale_factors)
        scores, zfs = self._scores(state, self._extract(crops))
        best = torch.argmax(scores.amax(dim=(-2, -1)))
        score = take(scores, best)
        conf, peak = max2d(score)
        peak = subpixel_peak(score, peak)
        disp_feat = peak - const([H // 2, W // 2], self.device)
        new_center = state.center + disp_feat * self._cell * take(pxs, best)
        new_sz = state.target_sz * take(self._scales, best)

        samples_t, weights_t, prev_t = [], [], []
        for bi, bank in enumerate(self.banks):
            h = w = bank.feat_sz
            zf_new = fourier_shift(take(zfs[bi], best), disp_feat * (bank.feat_sz / self._feat_sz),
                                   h, w)
            wts = state.weights[bi]
            r_ind = torch.argmin(wts).reshape(1)
            lr = bank.learning_rate
            first = state.prev_ind[bi] < 0
            w_first = (wts / (1.0 - lr)).index_fill(0, r_ind, lr)
            prev = torch.clamp(state.prev_ind[bi], min=0).reshape(1)
            w_next = wts.index_copy(0, r_ind, wts.index_select(0, prev) / (1.0 - lr))
            wts = torch.where(first, w_first, w_next)
            wts = wts / torch.sum(wts)
            samples_t.append(state.samples_f[bi].index_copy(0, r_ind, zf_new[None]))
            weights_t.append(wts)
            prev_t.append(r_ind[0])
        return state._replace(samples_f=tuple(samples_t), weights=tuple(weights_t),
                              prev_ind=tuple(prev_t), center=new_center,
                              target_sz=new_sz), conf

    # ----------------------------------------------------------------- host API
    @torch.no_grad()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        img = upload_image(image, self.device)
        box = torch.as_tensor(np.asarray(info["init_bbox"], np.float32), device=self.device)
        self._state = self._init_fn(img, box)
        self._frame = 0

    @torch.no_grad()
    def track(self, image: np.ndarray, info: Optional[dict] = None) -> dict:
        self._frame += 1
        img = upload_image(image, self.device)
        self._state, conf = self._track_fn(self._state, img)
        if self._frame % self.update_interval == 0:
            self._state = self._learn(self._state)
        vals = fetch(conf, self._state.center, self._state.target_sz)
        return {"target_bbox": box_xywh(vals[1:3], vals[3:5]), "pred_score": vals[0]}
