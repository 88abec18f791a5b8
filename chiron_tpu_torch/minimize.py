"""Energy minimization (port of ``chiron_tpu/minimize.py``).

* ``minimize_energy`` -- gradient descent with Armijo-flavoured
  backtracking (the reference's ``jaxopt.GradientDescent`` replacement,
  returning an object with ``.params``);
* ``fire_descent`` -- FIRE (Bitzek et al., PRL 97, 170201 (2006)).

JAX runs each as a ``lax.while_loop``.  Here the loop is on the host, on the
device of the coordinates, and reads the ``done`` flag only every
``CHECK_EVERY`` iterations (a host sync each): an iteration after ``done``
changes nothing and is not counted, so the result and the iteration count
are those of the loop that stops at once.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .potential import value_and_grad

CHECK_EVERY = 32


class MinimizeResult(NamedTuple):
    params: torch.Tensor
    energy: torch.Tensor
    n_iterations: torch.Tensor
    converged: torch.Tensor


def _wrap_objective(potential_fn: Callable, nbr_list) -> Callable:
    """A scalar objective of the positions from the reference-style inputs.

    ``potential_fn`` is usually a bound ``potential.compute_energy``; where
    its potential has ``make_energy_fn``, the objective is that closure on
    the list's state.
    """
    pot = getattr(potential_fn, "__self__", None)
    if pot is not None and hasattr(pot, "make_energy_fn"):
        try:
            energy_fn = pot.make_energy_fn(nbr_list)
        except TypeError:
            energy_fn = None
        if energy_fn is not None:
            list_state = nbr_list.state if nbr_list is not None else None
            return lambda x: energy_fn(x, list_state)
    if nbr_list is not None:
        return lambda x: potential_fn(x, nbr_list)
    return lambda x: potential_fn(x)


def _loop(body, state, maxiter: int):
    """Run ``body`` until ``state[-1]`` (done) holds or ``maxiter``
    iterations, reading the flag every ``CHECK_EVERY`` iterations."""
    for start in range(0, maxiter, CHECK_EVERY):
        for _ in range(min(CHECK_EVERY, maxiter - start)):
            state = body(state)
        if bool(state[-1]):
            break
    return state


def minimize_energy(
    coordinates: torch.Tensor,
    potential_fn: Callable,
    nbr_list=None,
    maxiter: int = 1000,
    tol: float = 1e-6,
) -> MinimizeResult:
    """Backtracking gradient descent: ``potential_fn(x, nbr_list)`` or
    ``potential_fn(x)``.  The neighbor list is not rebuilt during the
    minimization, as in the reference."""
    objective = _wrap_objective(potential_fn, nbr_list)
    x0 = torch.as_tensor(coordinates, dtype=torch.float32)
    dev = x0.device

    def body(state):
        x, e, g, lr, it, done = state
        x_new = x - lr * g
        e_new, g_new = value_and_grad(objective, x_new)
        # energy decreased: accept and grow the step; else shrink it and
        # retry from the same point
        accept = (e_new < e) & torch.isfinite(e_new)
        live = ~done
        take = live & accept
        x = torch.where(take, x_new, x)
        e = torch.where(take, e_new, e)
        g = torch.where(take, g_new, g)
        lr = torch.where(live, torch.where(accept, lr * 1.2, lr * 0.5), lr)
        gnorm = torch.sqrt(torch.sum(g * g))
        done = done | (live & ((gnorm < tol) | (lr < 1e-12)))
        return (x, e, g, lr, it + live.to(it.dtype), done)

    e0, g0 = value_and_grad(objective, x0)
    init = (x0, e0, g0, torch.tensor(1e-3, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))
    x, e, g, lr, it, done = _loop(body, init, maxiter)
    return MinimizeResult(params=x, energy=e, n_iterations=it, converged=done)


def fire_descent(
    coordinates: torch.Tensor,
    potential_fn: Callable,
    nbr_list=None,
    maxiter: int = 1000,
    dt_start: float = 1e-3,
    dt_max: float = 1e-2,
    f_tol: float = 1e-5,
) -> MinimizeResult:
    """FIRE (Fast Inertial Relaxation Engine): momentum-accelerated descent
    with an adaptive timestep."""
    objective = _wrap_objective(potential_fn, nbr_list)
    x0 = torch.as_tensor(coordinates, dtype=torch.float32)
    dev = x0.device
    alpha0, f_alpha, f_inc, f_dec, n_min = 0.1, 0.99, 1.1, 0.5, 5

    def body(state):
        x, v, e, g, dt, alpha, n_pos, it, done = state
        live = ~done
        F = -g
        # semi-implicit Euler
        v_new = v + dt * F
        power = torch.sum(F * v_new)
        fnorm = torch.sqrt(torch.sum(F * F)) + 1e-30
        vnorm = torch.sqrt(torch.sum(v_new * v_new))
        # mix the velocity toward the force direction
        v_new = (1.0 - alpha) * v_new + alpha * (F / fnorm) * vnorm
        uphill = power <= 0.0
        v_new = torch.where(uphill, torch.zeros_like(v_new), v_new)
        n_pos_new = torch.where(uphill, 0, n_pos + 1)
        grow = (~uphill) & (n_pos_new > n_min)
        dt_new = torch.where(grow, torch.clamp(dt * f_inc, max=dt_max),
                             torch.where(uphill, dt * f_dec, dt))
        alpha_new = torch.where(grow, alpha * f_alpha,
                                torch.where(uphill, alpha0, alpha))
        x_new = x + dt_new * v_new
        e_new, g_new = value_and_grad(objective, x_new)
        done_new = torch.max(torch.abs(g_new)) < f_tol

        def sel(new, old):
            return torch.where(live, new, old)

        return (sel(x_new, x), sel(v_new, v), sel(e_new, e), sel(g_new, g),
                sel(dt_new, dt), sel(alpha_new, alpha), sel(n_pos_new, n_pos),
                it + live.to(it.dtype), done | (live & done_new))

    e0, g0 = value_and_grad(objective, x0)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    init = (x0, torch.zeros_like(x0), e0, g0,
            torch.tensor(dt_start, device=dev), torch.tensor(alpha0, device=dev),
            zero, zero, torch.zeros((), dtype=torch.bool, device=dev))
    x, v, e, g, dt, alpha, n_pos, it, done = _loop(body, init, maxiter)
    return MinimizeResult(params=x, energy=e, n_iterations=it, converged=done)
