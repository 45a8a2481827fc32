"""Batched BFGS with the zoom line search, and the MLE's Newton polish.

Port of the solver the JAX package's gradient MLE uses
(``sxmc_tpu/stats/mle.py::_bfgs``): ``jax.scipy.optimize.minimize``'s
BFGS (Nocedal & Wright algorithm 6.1) with its strong-Wolfe line search
(algorithms 3.5 and 3.6: bracketing by doubling, then a zoom by cubic,
quadratic or bisection steps), ``gtol`` 1e-4 on the gradient's infinity
norm, then six damped Newton steps and Minuit's EDM < 0.01 convergence
test.  The algorithm is JAX's, decision for decision, including its
float32 thresholds (a zoom gives up on a bracket narrower than 1e-5, and
a step shorter than 1e-8 is lengthened to 1e-8).

Where JAX ``vmap``s one solve over a batch, every problem here is one row
of a batch: row b minimises ``f(x_b, *args_b)`` (:class:`Objective`:
values, gradients and Hessians of the whole batch by reverse passes of
the summed rows).  The nested loops of the sequential algorithm become
one loop of *ticks*: in a tick every unfinished row evaluates the
objective once, at the trial point its own state asks for (a bracketing
step or a zoom step), and then advances its own state machine, so that
each row sees exactly the sequence of evaluations the sequential
algorithm would.  A finished row is frozen: every update is a
``torch.where`` on the row's masks.  The host reads the "any row still
running" flag once every ``SYNC_EVERY`` ticks, so that Python does not
pace the card tick by tick.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

C1, C2 = 1e-4, 0.9          # Wolfe constants (line_search defaults)
LS_MAXITER = 10             # minimize_bfgs' line_search_maxiter
ZOOM_MAXITER = 30           # _zoom's cap
ZOOM_MIN_BRACKET = 1e-5     # _zoom's float32 threshold
MIN_STEP = 1e-8             # line_search's float32 step floor
SYNC_EVERY = 4              # ticks between reads of the done mask

_stats = {"ticks": 0, "syncs": 0, "solves": 0}


def solver_stats() -> dict:
    """Ticks (batched objective evaluations of the line searches), host
    reads of the done mask, and batched solves since the last reset."""
    return dict(_stats)


def reset_solver_stats() -> None:
    for k in _stats:
        _stats[k] = 0


class Objective:
    """A batch of independent problems: row b minimises ``f(x[b],
    *args_b)``, ``f`` taking the whole batch at once (``x`` ``(B, d)``,
    the per-row args with their leading axis and the shared ones
    broadcasting against it), as the NLL functions of ops.nll do.

    Rows are independent, so one reverse pass of the summed rows gives
    every row's gradient exactly, and d more passes of that gradient
    (double backward) every row's Hessian: the same derivatives as
    ``torch.func.hessian`` of one row under ``vmap`` (the tests hold the
    two together), at a fraction of its dispatch cost per call."""

    def __init__(self, f: Callable, args: Sequence = ()):
        self.f = f
        self.args = tuple(args)

    def value(self, x: torch.Tensor) -> torch.Tensor:
        return self.f(x, *self.args)

    def value_and_grad(self, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            v = self.f(x, *self.args)
            (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), g

    def hessian(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, d, d)`` Hessians at ``x`` ``(B, d)``."""
        d = x.shape[-1]
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            v = self.f(x, *self.args)
            (g,) = torch.autograd.grad(v.sum(), x, create_graph=True)
            rows = [torch.autograd.grad(g[:, i].sum(), x,
                                        retain_graph=i < d - 1)[0]
                    for i in range(d)]
        return torch.stack(rows, dim=-2)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` as float32 products and sums (no TF32 matmul:
    JAX's BFGS multiplies at HIGHEST precision)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """line_search.py::_cubicmin, elementwise."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d2a = fb - fa - C * db
    d2b = fc - fa - C * dc
    A = (dc ** 2 * d2a + (-db ** 2) * d2b) / denom
    B = ((-dc ** 3) * d2a + db ** 3 * d2b) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """line_search.py::_quadmin, elementwise."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


class _State:
    """Per-row tensors of the BFGS, line-search and zoom state."""

    def set(self, mask: torch.Tensor, **vals) -> None:
        masks = [mask]
        for name, v in vals.items():
            old = getattr(self, name)
            while len(masks) < old.dim():
                masks.append(masks[-1].unsqueeze(-1))
            setattr(self, name, torch.where(masks[old.dim() - 1], v, old))


def bfgs(obj: Objective, x0: torch.Tensor, maxiter: int,
         gtol: float = 1e-4):
    """Minimise every row of ``obj`` from ``x0`` ``(B, d)`` float32 by
    JAX's BFGS (``minimize(method="BFGS")``); returns ``(x, f,
    success)`` with ``success = converged & ~failed`` per row."""
    B, d = x0.shape
    dev, dt = x0.device, x0.dtype
    eye = torch.eye(d, dtype=dt, device=dev).expand(B, d, d)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    zero = torch.zeros(B, dtype=dt, device=dev)
    s = _State()
    s.x = x0.clone()
    s.f, s.g = obj.value_and_grad(s.x)
    s.H = eye.clone()
    s.oof = s.f + torch.linalg.vector_norm(s.g, dim=-1) / 2
    s.k = torch.zeros(B, dtype=torch.int64, device=dev)
    s.conv = s.g.abs().amax(-1) < gtol
    s.bfail = false.clone()
    # Line-search and zoom state: every field exists for every row.
    for name in ("phi0", "dphi0", "start", "a1", "phi1", "dphi1", "a_star",
                 "phi_star", "a_lo", "phi_lo", "dphi_lo", "a_hi", "phi_hi",
                 "dphi_hi", "a_rec", "phi_rec", "za_star", "zphi_star"):
        setattr(s, name, zero.clone())
    s.p = torch.zeros_like(s.x)
    s.g_star = torch.zeros_like(s.x)
    s.zg_star = torch.zeros_like(s.x)
    s.i = torch.zeros(B, dtype=torch.int64, device=dev)
    s.j = torch.zeros_like(s.i)
    for name in ("ls_done", "ls_fail", "zoom", "z_done", "z_fail"):
        setattr(s, name, false.clone())

    def running():
        return ~s.conv & ~s.bfail & (s.k < maxiter)

    def new_line_search(mask):
        p = -_mm(s.H, s.g.unsqueeze(-1)).squeeze(-1)
        dphi0 = _dot(s.g, p)
        cand = 1.01 * 2 * (s.f - s.oof) / dphi0
        s.set(mask, p=p, phi0=s.f, dphi0=dphi0,
              start=torch.where(cand > 1, torch.ones_like(cand), cand),
              i=torch.ones_like(s.i), a1=zero, phi1=s.f, dphi1=dphi0,
              ls_done=false, ls_fail=false, a_star=zero, phi_star=s.f,
              g_star=s.g, zoom=false)

    new_line_search(running())
    _stats["solves"] += 1
    tick = 0
    while True:
        if tick % SYNC_EVERY == 0:
            _stats["syncs"] += 1
            if not bool(running().any()):
                break
        tick += 1
        _stats["ticks"] += 1
        run = running()
        in_zoom = run & s.zoom
        bracket = run & ~s.zoom

        # The zoom's trial point (and its bracket check, made before the
        # evaluation as in _zoom's body).
        dalpha = s.a_hi - s.a_lo
        amin = torch.minimum(s.a_hi, s.a_lo)
        amax = torch.maximum(s.a_hi, s.a_lo)
        cchk, qchk = 0.2 * dalpha, 0.1 * dalpha
        s.set(in_zoom, z_fail=s.z_fail | (dalpha <= ZOOM_MIN_BRACKET))
        cubic = _cubicmin(s.a_lo, s.phi_lo, s.dphi_lo, s.a_hi, s.phi_hi,
                          s.a_rec, s.phi_rec)
        use_cubic = (s.j > 0) & (cubic > amin + cchk) & (cubic < amax - cchk)
        quad = _quadmin(s.a_lo, s.phi_lo, s.dphi_lo, s.a_hi, s.phi_hi)
        use_quad = ~use_cubic & (quad > amin + qchk) & (quad < amax - qchk)
        a_j = torch.where(use_cubic, cubic, s.a_rec)
        a_j = torch.where(use_quad, quad, a_j)
        a_j = torch.where(~use_cubic & ~use_quad, (s.a_lo + s.a_hi) / 2.0,
                          a_j)
        a_i = torch.where(s.i == 1, s.start, s.a1 * 2.0)
        alpha = torch.where(s.zoom, a_j, a_i)

        phi, g = obj.value_and_grad(s.x + alpha.unsqueeze(-1) * s.p)
        dphi = _dot(g, s.p)
        wolfe_one = phi > s.phi0 + C1 * alpha * s.dphi0
        wolfe_two = dphi.abs() <= -C2 * s.dphi0

        # Bracketing step (line_search's body).
        to_zoom1 = wolfe_one | ((phi >= s.phi1) & (s.i > 1))
        to_i = wolfe_two & ~to_zoom1
        to_zoom2 = (dphi >= 0.0) & ~to_zoom1 & ~to_i
        s.set(bracket & to_i, ls_done=~false, a_star=alpha, phi_star=phi,
              g_star=g)
        s.set(bracket & to_zoom1, a_lo=s.a1, phi_lo=s.phi1, dphi_lo=s.dphi1,
              a_hi=alpha, phi_hi=phi, dphi_hi=dphi)
        s.set(bracket & to_zoom2, a_lo=alpha, phi_lo=phi, dphi_lo=dphi,
              a_hi=s.a1, phi_hi=s.phi1, dphi_hi=s.dphi1)
        enter = bracket & (to_zoom1 | to_zoom2)
        s.set(enter, zoom=~false, j=torch.zeros_like(s.j),
              a_rec=(s.a_lo + s.a_hi) / 2.0,
              phi_rec=(s.phi_lo + s.phi_hi) / 2.0,
              za_star=torch.ones_like(zero), zphi_star=s.phi_lo,
              zg_star=s.g, z_done=false, z_fail=false)
        s.set(bracket, i=s.i + 1, a1=alpha, phi1=phi, dphi1=dphi)

        # Zoom step (_zoom's body), in its order of replacements.
        hi_to_j = wolfe_one | (phi >= s.phi_lo)
        star_to_j = wolfe_two & ~hi_to_j
        hi_to_lo = (dphi * (s.a_hi - s.a_lo) >= 0.0) & ~hi_to_j & ~star_to_j
        lo_to_j = ~hi_to_j & ~star_to_j
        s.set(in_zoom & hi_to_j, a_rec=s.a_hi, phi_rec=s.phi_hi)
        s.set(in_zoom & hi_to_j, a_hi=alpha, phi_hi=phi, dphi_hi=dphi)
        s.set(in_zoom & star_to_j, z_done=~false, za_star=alpha,
              zphi_star=phi, zg_star=g)
        s.set(in_zoom & hi_to_lo, a_rec=s.a_hi, phi_rec=s.phi_hi)
        s.set(in_zoom & hi_to_lo, a_hi=s.a_lo, phi_hi=s.phi_lo,
              dphi_hi=s.dphi_lo)
        s.set(in_zoom & lo_to_j & ~hi_to_lo, a_rec=s.a_lo, phi_rec=s.phi_lo)
        s.set(in_zoom & lo_to_j, a_lo=alpha, phi_lo=phi, dphi_lo=dphi)
        s.set(in_zoom, j=s.j + 1)
        s.set(in_zoom, z_fail=s.z_fail | (s.j >= ZOOM_MAXITER))
        zoom_end = in_zoom & (s.z_done | s.z_fail)
        s.set(zoom_end, ls_done=~false, ls_fail=s.ls_fail | s.z_fail,
              a_star=s.za_star, phi_star=s.zphi_star, g_star=s.zg_star,
              zoom=false)

        # A line search that ended: the BFGS update (minimize_bfgs' body).
        ended = run & ~s.zoom & (s.ls_done | s.ls_fail | (s.i > LS_MAXITER))
        a_k = torch.where(s.a_star.abs() < MIN_STEP,
                          torch.sign(s.a_star) * MIN_STEP, s.a_star)
        step = a_k.unsqueeze(-1) * s.p
        y = s.g_star - s.g
        rho = 1.0 / _dot(y, step)
        w = eye - rho[:, None, None] * (step.unsqueeze(-1) * y.unsqueeze(-2))
        h_new = (_mm(_mm(w, s.H), w.transpose(-1, -2))
                 + rho[:, None, None] * (step.unsqueeze(-1)
                                         * step.unsqueeze(-2)))
        h_new = torch.where(torch.isfinite(rho)[:, None, None], h_new, s.H)
        s.set(ended, bfail=s.ls_fail | ~s.ls_done,
              conv=s.g_star.abs().amax(-1) < gtol, k=s.k + 1,
              x=s.x + step, oof=s.f, f=s.phi_star, g=s.g_star, H=h_new)
        new_line_search(ended & running())

    return s.x, s.f, s.conv & ~s.bfail


def minimize(obj: Objective, x0: torch.Tensor, maxiter: int):
    """The JAX package's ``_bfgs`` (mle.py:505-545) on every row: BFGS,
    six damped Newton steps (a 1e-4 ridge, steps clipped to +-1,
    non-finite moves rejected), the better of the two points, and
    convergence by ``success | EDM < 0.01``.  Returns ``(x, f, ok)``."""
    xb, fb, success = bfgs(obj, x0, maxiter)
    d = x0.shape[-1]
    ridge = 1e-4 * torch.eye(d, dtype=x0.dtype, device=x0.device)

    def newton_step(x):
        _, g = obj.value_and_grad(x)
        h = obj.hessian(x) + ridge
        return g, torch.linalg.solve_ex(h, g.unsqueeze(-1))[0].squeeze(-1)

    x = xb
    for _ in range(6):
        _, step = newton_step(x)
        x_new = x - torch.clamp(step, -1.0, 1.0)
        ok = torch.isfinite(x_new).all(-1) & torch.isfinite(obj.value(x_new))
        x = torch.where(ok.unsqueeze(-1), x_new, x)
    f = obj.value(x)
    better = f <= fb
    x = torch.where(better.unsqueeze(-1), x, xb)
    f = torch.where(better, f, fb)
    g, hg = newton_step(x)
    edm = 0.5 * _dot(g, hg)
    return x, f, success | (edm.abs() < 0.01)
