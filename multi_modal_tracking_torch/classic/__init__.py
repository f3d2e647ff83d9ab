"""The classic trackers (ECO, ATOM, DiMP) and their DCF helpers and
solvers: the port's counterpart of the JAX package's `classic/`.

The JAX package runs them in XLA (FFTs, convolutions, eigh, jvp / vjp), with
no Pallas kernel; the port runs them in plain PyTorch (torch.fft, cuDNN,
torch.linalg, torch.func), eager, f32 with TF32 off.
"""
from multi_modal_tracking_torch.classic.optimization import (conjugate_gradient,  # noqa: F401
                                                             gauss_newton_cg,
                                                             gradient_descent_l2)

TRACKERS = ("eco", "atom", "dimp")


def build_classic_tracker(name: str, device="cuda", **kwargs):
    """A classic tracker by name ('eco' | 'atom' | 'dimp') on `device`
    (CUDA unless "cpu"; raises without a card)."""
    if name == "eco":
        from multi_modal_tracking_torch.classic.eco import ECOTracker
        return ECOTracker(device=device, **kwargs)
    if name == "atom":
        from multi_modal_tracking_torch.classic.atom import ATOMTracker
        return ATOMTracker(device=device, **kwargs)
    if name == "dimp":
        from multi_modal_tracking_torch.classic.dimp import DiMPTracker
        return DiMPTracker(device=device, **kwargs)
    raise ValueError(f"unknown classic tracker '{name}'")
