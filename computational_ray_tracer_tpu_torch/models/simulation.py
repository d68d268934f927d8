"""ODE solvers and the muscle crossbridge simulation
(``computational_ray_tracer_tpu/models/simulation.py``).

- Euler, Heun's RK2 and classic RK4 over a vector state, in float32, as a
  Python loop over the steps (the reference's ``lax.scan``).
- The two-state crossbridge model: N bridges attach with rate f and
  detach with rate g, one Bernoulli draw each a step; attached bridges
  are strained by the sliding velocity and pull with a linear spring. The
  draws are the reference's ``rng.independent_1d(seed, bridge, step, dim)``
  (dim 0 to attach, 1 to detach), bit for bit, so the attachment counts
  equal the reference's. They are drawn for a block of steps at a time
  (the hash of (seed, bridge) once, then (step, dim) on top of it); the
  state then advances one step at a time. A force-velocity sweep runs all
  its velocities as one batch: the draws do not depend on the velocity.
"""

from __future__ import annotations

import dataclasses

import torch

from computational_ray_tracer_tpu_torch.ops import rng as crng

_DRAW_BLOCK = 256   # steps of draws computed at once


def _solve(f, y0, t0, dt, n_steps, step_fn, device):
    y = torch.as_tensor(y0, dtype=torch.float32, device=device)
    t = torch.tensor(t0, dtype=torch.float32, device=device)
    ys = []
    for _ in range(n_steps):
        y = step_fn(f, y, t, dt)
        t = t + dt
        ys.append(y)
    ts = t0 + dt * (1 + torch.arange(n_steps, dtype=torch.float32,
                                     device=device))
    return ts, torch.stack(ys)


def _euler_step(f, y, t, dt):
    return y + dt * f(t, y)


def _rk2_step(f, y, t, dt):
    k1 = f(t, y)
    k2 = f(t + dt, y + dt * k1)
    return y + dt * 0.5 * (k1 + k2)


def _rk4_step(f, y, t, dt):
    k1 = f(t, y)
    k2 = f(t + dt / 2, y + dt / 2 * k1)
    k3 = f(t + dt / 2, y + dt / 2 * k2)
    k4 = f(t + dt, y + dt * k3)
    return y + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def euler(f, y0, t0, dt, n_steps, device="cuda"):
    """Euler's method for y' = f(t, y): (ts, ys), each step's end."""
    return _solve(f, y0, t0, dt, n_steps, _euler_step, device)


def rk2(f, y0, t0, dt, n_steps, device="cuda"):
    """Heun's RK2."""
    return _solve(f, y0, t0, dt, n_steps, _rk2_step, device)


def rk4(f, y0, t0, dt, n_steps, device="cuda"):
    """Classic RK4."""
    return _solve(f, y0, t0, dt, n_steps, _rk4_step, device)


SOLVERS = {"euler": euler, "rk2": rk2, "rk4": rk4}


@dataclasses.dataclass(frozen=True)
class CrossbridgeConfig:
    n_bridges: int = 10000
    attach_rate: float = 14.0     # f, 1/s
    detach_rate: float = 126.0    # g, 1/s
    dt: float = 1e-3              # s
    spring_k: float = 1.0         # pN/nm
    x_attach: float = 8.0         # nm: power-stroke attachment position
    seed: int = 0


def _simulate(cfg, n_steps, velocities, device):
    """The crossbridge population under each sliding velocity (V,):
    attachment counts (n_steps,), forces (n_steps, V), the final attached
    mask (N,) and strains (V, N)."""
    n = cfg.n_bridges
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    p_attach, p_detach = (f32(r * cfg.dt) for r in (cfg.attach_rate,
                                                    cfg.detach_rate))
    v_dt = torch.as_tensor(velocities, dtype=torch.float32,
                           device=device)[:, None] * cfg.dt
    bridge_hash = crng.hash_u32(cfg.seed, torch.arange(n, device=device))
    attached = torch.zeros(n, dtype=torch.bool, device=device)
    x = torch.zeros((v_dt.shape[0], n), dtype=torch.float32, device=device)
    counts, forces = [], []
    for s0 in range(0, n_steps, _DRAW_BLOCK):
        steps = torch.arange(s0, min(s0 + _DRAW_BLOCK, n_steps),
                             device=device)
        h = crng.hash_u32(steps[:, None], h=bridge_hash)     # (B, N)
        attach_ok = crng.u32_to_float(crng.hash_u32(0, h=h)) < p_attach
        detach_ok = crng.u32_to_float(crng.hash_u32(1, h=h)) < p_detach
        for k in range(steps.shape[0]):
            attach_now = ~attached & attach_ok[k]
            detach_now = attached & detach_ok[k]
            attached = (attached | attach_now) & ~detach_now
            x = torch.where(attach_now, cfg.x_attach, x - v_dt)
            x = torch.where(attached, x, 0.0)
            counts.append(attached.sum())
            forces.append(torch.where(attached, cfg.spring_k * x, 0.0).sum(-1))
    return torch.stack(counts), torch.stack(forces), attached, x


def simulate_crossbridges(cfg: CrossbridgeConfig, n_steps: int,
                          velocity=0.0, device="cuda"):
    """Advance the bridges n_steps at sliding ``velocity`` (nm/s): each
    step a detached bridge attaches w.p. f dt at x_attach, an attached one
    detaches w.p. g dt, attached strains move by -v dt, force = sum k x.
    Returns the per-step ``n_attached`` and ``force`` and the
    ``final_attached`` mask and ``final_x`` strains."""
    n_att, force, attached, x = _simulate(cfg, n_steps, [velocity], device)
    return {"n_attached": n_att, "force": force[:, 0],
            "final_attached": attached, "final_x": x[0]}


def steady_state_attachment_fraction(cfg: CrossbridgeConfig):
    """Analytic steady state of the two-state model: f / (f + g)."""
    return cfg.attach_rate / (cfg.attach_rate + cfg.detach_rate)


def force_velocity_curve(cfg: CrossbridgeConfig, velocities, n_steps=2000,
                         n_average=500, device="cuda"):
    """Mean force over the last ``n_average`` of ``n_steps`` steps at each
    sliding velocity, as a NumPy array."""
    _, force, _, _ = _simulate(cfg, n_steps, velocities, device)
    return force[-n_average:].mean(0).cpu().numpy()
