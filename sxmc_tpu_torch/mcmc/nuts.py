"""The No-U-Turn Sampler (multinomial NUTS) over the extended-ML
posterior (port of ``sxmc_tpu/mcmc/nuts.py``).

The trajectory doubles up to ``max_depth`` (8) levels.  At level d a
direction is drawn, a subtree of 2^d leapfrogs is built from that end
of the trajectory with progressive multinomial sampling inside it
(weights exp(H0 - H)), and the subtree is merged multinomially unless it
turned or diverged; the tree stops on a U-turn of a subtree or of the
whole trajectory, or on a divergence (``-dH > DIVERGENCE``, or a
non-finite energy).  The log-rate reparameterisation, the dual-averaging
warmup and the mass adaptation are HMC's (:mod:`.hmc`).

Lock-step chains run as one batch: a level is built for every chain,
and a chain whose tree has stopped keeps its state (every update is a
``torch.where`` on its done mask), which is what the JAX package's
``vmap`` of ``lax.cond`` computes.  The host reads the done mask once a
level, to stop when every chain is done: a step costs one evaluation for
the gradient at its start and one a leaf of each level run (the
potential and its gradient together).

Draws of a step (:meth:`NUTS.presample`): the momentum normals, and per
level a direction uniform (forward where < 0.5: JAX's ``bernoulli(k,
0.5)``), a merge uniform, and the subtree's leaf uniforms, level d's
2^d of them at offset 2^d - 1 (255 a step at depth 8).  The
checkpointable segments are HMC's (``hmc.initial_warm_carry``,
``warmup_segment``, ``main_segment``), which dispatch on the sampler.
"""

from __future__ import annotations

import torch

from sxmc_tpu_torch.mcmc import hmc as hmc_mod
from sxmc_tpu_torch.mcmc.hmc import HMC, kinetic, momentum

DIVERGENCE = 1000.0


class NUTS(HMC):
    """The NUTS fit, with the call contract of MCMC and HMC."""

    def __init__(self, *args, max_depth: int = 8, **kwargs):
        kwargs.setdefault("target_accept", 0.8)
        super().__init__(*args, **kwargs)
        self.max_depth = int(max_depth)

    def _fns(self, read_bins: torch.Tensor):
        return _make_nuts_fns(self, read_bins)

    def draw_shapes(self, n: int, nchains: int = 1):
        lead = (n,) + ((nchains,) if nchains > 1 else ())
        depth = self.max_depth
        return (lead + (self.nparameters,), lead + (depth,),
                lead + (depth,), lead + (2 ** depth - 1,))

    def presample(self, gen: torch.Generator, n: int, nchains: int = 1):
        """A phase's draws from ``gen``: momentum normals ``(n,
        [nchains,] npar)``, direction and merge uniforms ``(n, [nchains,]
        max_depth)``, leaf uniforms ``(n, [nchains,] 2^max_depth -
        1)``."""
        shapes = self.draw_shapes(n, nchains)
        mom = torch.randn(shapes[0], generator=gen, device=self.device,
                          dtype=torch.float32)
        return (mom,) + tuple(
            torch.rand(s, generator=gen, device=self.device,
                       dtype=torch.float32) for s in shapes[1:])


def _where(mask, new, old):
    """``new`` where ``mask`` (per chain), else ``old``; q-like entries
    carry a trailing parameter axis."""
    if new.dim() > mask.dim():
        mask = mask[..., None]
    return torch.where(mask, new, old)


def _make_nuts_fns(nuts: NUTS, read_bins: torch.Tensor):
    """NUTS's warm and sampling bodies (nuts.py:83-298)."""
    t = hmc_mod._target(nuts, read_bins)
    free, q0 = t.free, t.q0
    max_depth = nuts.max_depth

    def uturn(q_left, p_left, q_right, p_right, inv_mass):
        dq = q_right - q_left
        return (((dq * inv_mass * p_left).sum(-1) < 0)
                | ((dq * inv_mass * p_right).sum(-1) < 0))

    def build_subtree(start, h0, direction, nleaf, eps, inv_mass, leaf_u):
        """2^d leapfrogs from ``start = (q, p, g)``, progressive
        multinomial sampling within (nuts.py:153-197)."""
        start_q, start_p, _ = start
        q, p, g = start
        e = (direction * eps)[..., None]
        right = (direction > 0)[..., None]
        log_w = torch.full_like(h0, -torch.inf)
        qp, up = q, torch.zeros_like(h0)
        turn = torch.zeros_like(h0, dtype=torch.bool)
        div = torch.zeros_like(turn)
        a_sum = torch.zeros_like(h0)
        for i in range(nleaf):
            p = p - 0.5 * e * g
            q = q + e * inv_mass * p
            q = torch.where(free, q, q0)
            u, g = t.value_and_grad(q)
            p = p - 0.5 * e * g
            h = u + kinetic(p, inv_mass)
            dh = h0 - h
            div = div | ~torch.isfinite(h) | (-dh > DIVERGENCE)
            w = torch.where(div, torch.full_like(dh, -torch.inf), dh)
            new_log_w = torch.logaddexp(log_w, w)
            take = torch.log(leaf_u[..., i]) < (w - new_log_w)
            qp = _where(take, q, qp)
            up = torch.where(take, u, up)
            a_sum = a_sum + torch.minimum(torch.exp(dh),
                                          torch.ones_like(dh))
            turn = turn | uturn(torch.where(right, start_q, q),
                                torch.where(right, start_p, p),
                                torch.where(right, q, start_q),
                                torch.where(right, p, start_p), inv_mass)
            log_w = new_log_w
        return (q, p, g), log_w, qp, up, turn, div, a_sum

    def level(d, st, h0, eps, inv_mass, dir_u, merge_u, leaf_u):
        """One doubling (nuts.py:199-250)."""
        direction = torch.where(dir_u < 0.5, torch.ones_like(dir_u),
                                -torch.ones_like(dir_u))
        fwd = direction > 0
        start = tuple(_where(fwd, st["r" + k], st["l" + k])
                      for k in ("q", "p", "g"))
        end, sub_log_w, sub_q, sub_u, sub_turn, sub_div, a_sum = \
            build_subtree(start, h0, direction, 2 ** d, eps, inv_mass,
                          leaf_u)
        new = dict(st)
        new["alpha_sum"] = st["alpha_sum"] + a_sum
        new["alpha_n"] = st["alpha_n"] + 2.0 ** d
        stop_now = sub_turn | sub_div
        total = torch.logaddexp(st["log_w"], sub_log_w)
        take = ~stop_now & (torch.log(merge_u) < (sub_log_w - total))
        new["q_prop"] = _where(take, sub_q, st["q_prop"])
        new["u_prop"] = torch.where(take, sub_u, st["u_prop"])
        new["log_w"] = torch.where(stop_now, st["log_w"], total)
        for side, mask in (("l", ~fwd & ~stop_now), ("r", fwd & ~stop_now)):
            for k, x in zip(("q", "p", "g"), end):
                new[side + k] = _where(mask, x, st[side + k])
        overall = uturn(new["lq"], new["lp"], new["rq"], new["rp"],
                        inv_mass)
        new["done"] = st["done"] | stop_now | overall
        return new

    def nuts_step(q, u_q, eps, inv_mass, xs):
        """One NUTS transition (nuts.py:129-268): the proposal, its
        potential and the mean acceptance statistic of the tree."""
        mom, dir_u, merge_u, leaf_u = xs
        p0 = momentum(mom, inv_mass)
        _, g0 = t.value_and_grad(q)
        h0 = u_q + kinetic(p0, inv_mass)
        zero = torch.zeros_like(u_q)
        st = dict(lq=q, lp=p0, lg=g0, rq=q, rp=p0, rg=g0, q_prop=q,
                  u_prop=u_q, log_w=zero, done=torch.zeros_like(
                      u_q, dtype=torch.bool), alpha_sum=zero, alpha_n=zero)
        for d in range(max_depth):
            if bool(st["done"].all()):
                break
            new = level(d, st, h0, eps, inv_mass, dir_u[..., d],
                        merge_u[..., d], leaf_u[..., 2 ** d - 1:])
            done = st["done"]
            st = {k: _where(done, v, new[k]) for k, v in st.items()}
        t.leapfrogs += float(st["alpha_n"].sum())
        alpha = st["alpha_sum"] / torch.clamp_min(st["alpha_n"], 1.0)
        return st["q_prop"], st["u_prop"], alpha

    def main_body(eps, inv_mass):
        def body(carry, xs):
            q, u_q = carry
            q, u_q, alpha = nuts_step(q, u_q, eps, inv_mass, xs)
            return ((q, u_q), (t.to_constrained(q), u_q + t.jacobian(q),
                               alpha))
        return body

    t.warm_body = hmc_mod.warm_body(nuts_step, t.inv_mass0,
                                    nuts.target_accept)
    t.main_body = main_body
    return t
