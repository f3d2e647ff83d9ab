"""Solvers of the classic trackers over trees of real and complex tensors:
the port's counterpart of the JAX package's `classic/optimization.py`
(pytracking's ConjugateGradient, GaussNewtonCG, GradientDescentL2).

A tree is a tensor, or a dict / tuple / list of them, real or complex.
Every solver runs a fixed number of iterations and makes every decision
on the device (`torch.where`), so an iteration never reads a value back
to the host. The adjoint J^H w is one reverse pass through a graph of r
built once per linearisation; J dx comes from `torch.func.jvp`, or from
the caller where it writes J dx out (`jvp_fn`, the trackers do):
torch.func's transforms cost tens of microseconds of host time per
operation, and ECO's init makes tens of thousands of them.

The adjoint on complex leaves: PyTorch's vjp of a complex map already
returns the conjugate-Wirtinger (Hermitian) adjoint J^H w, the adjoint of
J under the real inner product Re<a, b> that least squares needs. JAX's
vjp returns the unconjugated transpose J^T w, which the JAX package wraps
in conjugates; copying that wrap here would make the normal equations
non-Hermitian (tests/test_torch_port_classic_ops.py holds both facts).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.utils._pytree as pytree
from torch.func import jvp

Tree = Any


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    """Re sum over leaves of <a, b> (a conjugated): the real inner product."""
    out = None
    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        d = torch.vdot(x.reshape(-1), y.reshape(-1))
        d = d.real if d.is_complex() else d
        out = d if out is None else out + d
    return out


def _axpy(alpha, x: Tree, y: Tree) -> Tree:
    return pytree.tree_map(lambda u, v: alpha * u + v, x, y)


class CGResult(NamedTuple):
    x: Tree
    residual_norms: torch.Tensor   # (num_iter,) rho after each iteration


def conjugate_gradient(A: Callable[[Tree], Tree], b: Tree, x0: Optional[Tree] = None,
                       num_iter: int = 10, forgetting_rate: Optional[float] = None,
                       precond: Optional[Callable[[Tree], Tree]] = None,
                       eps: float = 0.0) -> CGResult:
    """Preconditioned CG for A x = b over trees (pytracking run_CG), a
    fixed num_iter iterations; `eps` guards rho == 0 and p^T A p <= eps
    without leaving the loop early. `forgetting_rate` divides the previous
    rho (the reference's direction forgetting); None is Fletcher-Reeves."""
    if x0 is None:
        x = pytree.tree_map(torch.zeros_like, b)
        r = b
    else:
        x = x0
        r = pytree.tree_map(lambda u, v: u - v, b, A(x0))
    M = precond if precond is not None else (lambda t: t)
    z = M(r)
    p = z
    rho = tree_dot(r, z)
    trace = []
    for _ in range(num_iter):
        Ap = A(p)
        pAp = tree_dot(p, Ap)
        alpha = torch.where(pAp > eps, rho / torch.clamp(pAp, min=1e-30),
                            torch.zeros_like(pAp))
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, Ap, r)
        z = M(r)
        rho_new = tree_dot(r, z)
        denom = rho if forgetting_rate is None else forgetting_rate * rho
        beta = rho_new / torch.clamp(denom, min=1e-30)
        beta = torch.where(rho > eps, beta, torch.zeros_like(beta))
        p = _axpy(beta, p, z)
        rho = rho_new
        trace.append(rho_new)
    norms = torch.stack(trace) if trace else rho.new_zeros(0)
    return CGResult(x=x, residual_norms=norms)


def _adjoint(residual_fn: Callable[[Tree], Tree], x: Tree):
    """r(x) and w -> J^H w by reverse mode: the graph of r is built once and
    each product is one backward pass through it (torch.autograd.grad; the
    adjoint torch.func.vjp gives, with less dispatch per operation)."""
    leaves, spec = pytree.tree_flatten(x)
    req = [leaf.detach().requires_grad_(True) for leaf in leaves]
    with torch.enable_grad():
        r0 = residual_fn(pytree.tree_unflatten(req, spec))
    outs, out_spec = pytree.tree_flatten(r0)

    def JH(w):
        grads = torch.autograd.grad(outs, req, pytree.tree_leaves(w), retain_graph=True,
                                    allow_unused=True)
        return pytree.tree_unflatten([torch.zeros_like(leaf) if g is None else g
                                      for g, leaf in zip(grads, leaves)], spec)

    return pytree.tree_unflatten([o.detach() for o in outs], out_spec), JH


def solve_normal_equations(residual_fn: Callable[[Tree], Tree], x: Tree, num_iter: int = 10,
                           reg=None, precond: Optional[Callable[[Tree], Tree]] = None,
                           jvp_fn: Optional[Callable[[Tree, Tree], Tree]] = None) -> Tree:
    """One linearised least-squares step: minimise ||r(x + dx)||^2 through
    r(x) + J dx, i.e. solve (J^H J + reg I) dx = -J^H r(x) by CG, and
    return x + dx. `precond` is applied inside CG. `jvp_fn(x, dx)`, when
    given, is J dx written out (the trackers' residuals are linear or
    bilinear); without it J dx comes from torch.func.jvp, which re-runs r
    under forward-mode AD at every product."""
    r0, JH = _adjoint(residual_fn, x)

    def J(dx):
        if jvp_fn is None:
            return jvp(residual_fn, (x,), (dx,))[1]
        return jvp_fn(x, dx)

    def A(dx):
        out = JH(J(dx))
        if reg is not None:                 # Levenberg damping
            out = _axpy(reg, dx, out)
        return out

    neg_Jtr = JH(pytree.tree_map(lambda u: -u, r0))
    res = conjugate_gradient(A, neg_Jtr, num_iter=num_iter, precond=precond)
    return pytree.tree_map(lambda u, v: u + v, x, res.x)


def gauss_newton_cg(residual_fn: Callable[[Tree], Tree], x0: Tree, num_gn_iter: int = 3,
                    num_cg_iter: int = 5, reg=None,
                    precond: Optional[Callable[[Tree], Tree]] = None,
                    jvp_fn: Optional[Callable[[Tree, Tree], Tree]] = None) -> Tree:
    """Gauss-Newton: num_gn_iter re-linearisations around the CG solve."""
    x = x0
    for _ in range(num_gn_iter):
        x = solve_normal_equations(residual_fn, x, num_iter=num_cg_iter, reg=reg,
                                   precond=precond, jvp_fn=jvp_fn)
    return x


def gradient_descent_l2(loss_fn: Callable[[Tree], torch.Tensor], x0: Tree, num_iter: int = 10,
                        step_length: float = 1.0, momentum: float = 0.0) -> Tree:
    """Plain gradient descent with heavy-ball momentum on a scalar loss
    (v = g + momentum v; x -= step_length v)."""
    grad_fn = torch.func.grad(loss_fn)
    x = x0
    v = pytree.tree_map(torch.zeros_like, x0)
    for _ in range(num_iter):
        g = grad_fn(x)
        v = _axpy(momentum, v, g)
        x = _axpy(-step_length, v, x)
    return x


def steepest_descent_quadratic(A: Callable[[Tree], Tree], b: Tree, x0: Tree,
                               num_iter: int = 5) -> Tree:
    """Steepest descent with exact line search on 0.5 x^T A x - b^T x
    (alpha = r^T r / r^T A r). A generic solver of the library; DiMP's
    learned optimizer is `dimpnet.DiMPSteepestDescentGN`."""
    x = x0
    for _ in range(num_iter):
        r = pytree.tree_map(lambda u, v: u - v, b, A(x))
        Ar = A(r)
        alpha = tree_dot(r, r) / torch.clamp(tree_dot(r, Ar), min=1e-30)
        x = _axpy(alpha, r, x)
    return x
